"""Text cleaning helpers for subtitle/caption streams (the port's copy of
``xpretrain_tpu/data/text_clean.py``).

The reference ships the Glasgow IR stop-word list
(``CLIP-ViP/src/utils/stop_words.py``, imported by the pretrain datasets);
here it backs an actually-wired ``remove_stop_words`` plus subtitle
normalization used by the ingest tooling. The list is the standard public
Glasgow Information Retrieval Group resource.
"""

from __future__ import annotations

import re

ENGLISH_STOP_WORDS = frozenset(
    """a about above across actually after afterwards again against all almost
alone along already also although always am among amongst amoungst amount an
and another any anyhow anyone anything anyway anywhere are around as at back
be became because become becomes becoming been before beforehand behind being
below beside besides between beyond bill both bottom but by call can cannot
cant can't co con could couldnt cry de describe detail do done don't down due
during each easy eg eight either eleven else elsewhere empty enough etc even
ever every everyone everything everywhere except few fifteen fifty find fire
first five for former formerly forty found four from further give had has
hasnt have he hence her here hereafter hereby herein hereupon hers herself him
himself his how however hundred i ie if i'm i'll i've in inc indeed interest
is it it'll its it's itself just keep last latter latterly least less like ltd
made many may me meanwhile might mill mine more moreover most mostly move much
must my myself name namely neither never nevertheless next nine no nobody none
noone nor not nothing now nowhere of off often oh on once one only onto or
other others otherwise our ours ourselves out over own part per perhaps please
put rather re really said same see seem seemed seeming seems serious several
she should show side since sincere six sixty so some somehow someone something
sometime sometimes somewhere still such system take ten than that the their
them themselves then thence there thereafter thereby therefore therein
thereupon these they thick thin third this those though three through
throughout thru thus to together too top toward towards twelve twenty two un
under until up upon us very via want was we well were what whatever when
whence whenever where whereafter whereas whereby wherein whereupon wherever
whether which while whither who whoever whole whom whose why will with within
without would yet you your yours yourself yourselves""".split()
)


def remove_stop_words(text: str) -> str:
    return " ".join(w for w in text.split() if w.lower() not in ENGLISH_STOP_WORDS)


_SUBTITLE_NOISE = re.compile(r"\[[^\]]*\]|\([^)]*\)|<[^>]*>|♪|#|\*")


def clean_subtitle(text: str) -> str:
    """Strip bracketed sound effects, markup, and music glyphs; collapse space."""
    text = _SUBTITLE_NOISE.sub(" ", text)
    return re.sub(r"\s+", " ", text).strip()
