"""Self-contained tokenizers + MLM masking for the text pipeline (the port's
copy of ``xpretrain_tpu/data/tokenization.py``).

The reference leans on HF tokenizers (``CLIPTokenizerFast`` /
``BertTokenizerFast``) fetched from the hub. This stack ships the two
algorithms those wrap — CLIP's lower-cased byte-level-ish BPE and BERT
WordPiece — as dependency-free implementations that load the standard asset
files (``vocab.json``+``merges.txt``, ``vocab.txt``) users already have with
their checkpoints. A deterministic :class:`HashTokenizer` covers synthetic /
test pipelines with no assets at all (the ``dummy_data`` path of the
reference, ``dataset_video_retrieval.py:126-130``).

MLM masking reproduces the HF-style 15% / 80-10-10 scheme of
``CLIP-ViP/src/datasets/data_utils.py:23-71``.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import html
import json
import os
import re
from typing import Iterable, Sequence

try:  # Unicode word classes (\p{L}/\p{N}) need the `regex` module; the
    # stdlib fallback is ASCII-only and breaks non-Latin caption parity.
    import regex as _regex

    _HAS_UNICODE_RE = True
except ImportError:  # pragma: no cover
    _regex = re
    _HAS_UNICODE_RE = False

import numpy as np


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte<->unicode table (standard algorithm)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(
        range(ord("®"), ord("ÿ") + 1)
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


class ClipBPETokenizer:
    """CLIP's text tokenizer (BPE over byte-encoded lowercased words).

    Loads ``vocab.json`` (+ ``merges.txt``) or the OpenAI
    ``bpe_simple_vocab_16e6.txt.gz``; ids match
    ``openai/clip-vit-base-patch32`` so converted checkpoints line up.
    """

    def __init__(self, vocab_path: str, merges_path: str | None = None):
        self.byte_encoder = bytes_to_unicode()
        if vocab_path.endswith(".gz"):
            # OpenAI single-file format: merges list defines the vocab order
            with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges]
            vocab = list(self.byte_encoder.values())
            vocab = vocab + [v + "</w>" for v in vocab]
            for m in merges:
                vocab.append("".join(m))
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = {tok: i for i, tok in enumerate(vocab)}
            self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        else:
            with open(vocab_path, "r", encoding="utf-8") as f:
                self.encoder = json.load(f)
            with open(merges_path, "r", encoding="utf-8") as f:
                merges = f.read().split("\n")
                merges = [tuple(m.split()) for m in merges if m and not m.startswith("#version")]
            self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bot_id = self.encoder["<|startoftext|>"]
        self.eot_id = self.encoder["<|endoftext|>"]
        self.pad_id = 0
        # HF CLIPTokenizer's word-split pattern; Unicode \p{L}/\p{N} classes
        # so non-Latin captions tokenize identically to the checkpoints'
        # training tokenizer (ADVICE r1: the ASCII classes silently diverged).
        if _HAS_UNICODE_RE:
            self.pat = _regex.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
                _regex.IGNORECASE,
            )
        else:  # pragma: no cover - stdlib fallback, ASCII-only
            self.pat = re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
                re.IGNORECASE,
            )

    @functools.lru_cache(maxsize=65536)
    def _bpe(self, token: str) -> str:
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        return " ".join(word)

    def encode(self, text: str) -> list[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: list[int] = []
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" ") if t in self.encoder)
        return ids

    def __call__(self, texts: Sequence[str], max_len: int = 77) -> tuple[np.ndarray, np.ndarray]:
        return batch_encode(self, texts, max_len, self.bot_id, self.eot_id, self.pad_id)


class WordPieceTokenizer:
    """BERT WordPiece over a ``vocab.txt``; uncased basic tokenization."""

    def __init__(self, vocab_path: str, lowercase: bool = True):
        with open(vocab_path, "r", encoding="utf-8") as f:
            self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.lowercase = lowercase
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.pad_id = self.vocab["[PAD]"]
        self.mask_id = self.vocab["[MASK]"]
        self.unk_id = self.vocab["[UNK]"]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _basic(self, text: str) -> list[str]:
        if self.lowercase:
            text = text.lower()
        text = re.sub(r"([^\w\s])", r" \1 ", text)
        return text.split()

    def _wordpiece(self, word: str) -> list[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in self._basic(text):
            ids.extend(self._wordpiece(word))
        return ids

    def __call__(self, texts: Sequence[str], max_len: int = 64) -> tuple[np.ndarray, np.ndarray]:
        return batch_encode(self, texts, max_len, self.cls_id, self.sep_id, self.pad_id)


class HashTokenizer:
    """Deterministic words->ids tokenizer for synthetic/test pipelines.

    Special ids derive from ``vocab_size`` (BOT = vocab-2, EOT = vocab-1) so
    every id stays in-vocab for any embedding table; the defaults match
    CLIP's 49406/49407. EOT being the highest id preserves the
    argmax-pooling invariant of the CLIP text tower.
    """

    def __init__(
        self,
        vocab_size: int = 49408,
        bot_id: int | None = None,
        eot_id: int | None = None,
    ):
        self.vocab_size = vocab_size
        self.bot_id = vocab_size - 2 if bot_id is None else bot_id
        self.eot_id = vocab_size - 1 if eot_id is None else eot_id
        if max(self.bot_id, self.eot_id) >= vocab_size:
            raise ValueError("special ids must be < vocab_size")
        self.pad_id = 0
        self.mask_id = 1
        self.cls_id, self.sep_id = self.bot_id, self.eot_id

    def encode(self, text: str) -> list[int]:
        out = []
        for word in text.lower().split():
            h = int(hashlib.md5(word.encode()).hexdigest()[:8], 16)
            out.append(2 + h % (self.vocab_size - 4))
        return out

    def __call__(self, texts: Sequence[str], max_len: int = 77) -> tuple[np.ndarray, np.ndarray]:
        return batch_encode(self, texts, max_len, self.bot_id, self.eot_id, self.pad_id)


def batch_encode(
    tok, texts: Sequence[str], max_len: int, start_id: int, end_id: int, pad_id: int
) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-length [B, L] ids + attention mask, start/end tokens included.

    Matches the reference collators' ``batch_encode_plus(..., truncation=True,
    padding="max_length")`` contract (``dataset_video_retrieval.py:152-183``).
    """
    ids = np.full((len(texts), max_len), pad_id, dtype=np.int64)
    mask = np.zeros((len(texts), max_len), dtype=np.int64)
    for i, text in enumerate(texts):
        body = tok.encode(text)[: max_len - 2]
        row = [start_id] + body + [end_id]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return ids, mask


def build_tokenizer(kind: str = "hash", **kwargs):
    if kind == "clip_bpe":
        return ClipBPETokenizer(**kwargs)
    if kind == "wordpiece":
        return WordPieceTokenizer(**kwargs)
    if kind == "hash":
        return HashTokenizer(**kwargs)
    raise ValueError(f"unknown tokenizer kind {kind!r}")


def build_model_tokenizer(kind: str, model_vocab_size: int, **kwargs):
    """Tokenizer builder clamped to the consuming model's embedding table.

    The synthetic hash tokenizer defaults to the CLIP vocab (49408); BERT
    tables are smaller (30522), and an out-of-range id has no embedding row. Every runner that feeds a model
    should build its tokenizer through here.
    """
    if kind == "hash":
        kwargs.setdefault("vocab_size", int(model_vocab_size))
    return build_tokenizer(kind, **kwargs)


def mask_batch_text_tokens(
    ids: np.ndarray,
    mask_token_id: int,
    vocab_size: int,
    rng: np.random.Generator,
    mlm_prob: float = 0.15,
    special_ids: Iterable[int] = (),
    ignore_index: int = -100,
) -> tuple[np.ndarray, np.ndarray]:
    """HF-style MLM masking: 15% selected; of those 80% [MASK], 10% random,
    10% unchanged. Returns (masked_ids, labels) with non-selected = -100."""
    ids = ids.copy()
    labels = ids.copy()
    special = np.isin(ids, np.fromiter(special_ids, dtype=ids.dtype, count=-1)) if special_ids else np.zeros_like(ids, dtype=bool)
    prob = np.where(special, 0.0, mlm_prob)
    selected = rng.random(ids.shape) < prob
    labels[~selected] = ignore_index
    replace_mask = selected & (rng.random(ids.shape) < 0.8)
    ids[replace_mask] = mask_token_id
    random_mask = selected & ~replace_mask & (rng.random(ids.shape) < 0.5)
    ids[random_mask] = rng.integers(0, vocab_size, size=int(random_mask.sum()))
    return ids, labels
