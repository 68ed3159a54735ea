"""Operations and bytes of each configuration's work, counted from its
published shapes and never from what implements them: one file per
configuration. A forward counts its GEMMs and its attention by pattern (the
scores a token may attend, not a dense masked product); a training step
counts a forward and two forwards' worth for the backward, no recompute."""
