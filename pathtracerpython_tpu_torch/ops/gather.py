"""Component-major row lookup.

The JAX package turns small-table lookups into one-hot matmuls to suit
the TPU's layout; on the card a gather is the natural form, so ``cm_take``
is an ``index_select``.
"""

from __future__ import annotations

import torch


def cm_take(table_cm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table_cm [C, R] indexed by ``idx`` of any shape -> [C, *idx.shape]."""
    out = table_cm.index_select(1, idx.reshape(-1).to(torch.int64))
    return out.reshape((table_cm.shape[0],) + tuple(idx.shape))
