"""Seeded weights for both sides of a cell: the program and the plain
reference take the same tensors, made here on the device in one draw.

A reference module lists its parameters as :class:`Leaf` entries (name,
shape, mean, std) under the program's own parameter names;
:func:`make_weights` draws one normal buffer from ``--seed`` with a
``torch.Generator`` on the device and cuts it into those leaves.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple[int, ...]
    mean: float
    std: float


def make_weights(leaves: list[Leaf], seed: int, device: torch.device | str) -> dict[str, torch.Tensor]:
    """{name: fp32 tensor} drawn from ``seed``: one ``randn`` over every
    element, then each leaf scaled to its mean and std (views of one buffer)."""
    total = sum(math.prod(leaf.shape) for leaf in leaves)
    g = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for leaf in leaves:
        n = math.prod(leaf.shape)
        w = buf[offset:offset + n].view(leaf.shape)
        w.mul_(leaf.std).add_(leaf.mean)
        out[leaf.name] = w
        offset += n
    return out


def load_into(module: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s parameters by name; the two sets of
    names and shapes must be equal."""
    params = dict(module.named_parameters())
    missing, extra = sorted(set(params) - set(weights)), sorted(set(weights) - set(params))
    if missing or extra:
        raise KeyError(f"the reference's leaves and the program's parameters differ: "
                       f"program only {missing[:8]}, reference only {extra[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: program {tuple(p.shape)} != reference {tuple(weights[name].shape)}")
            p.copy_(weights[name])
