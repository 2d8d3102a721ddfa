"""Component-major row lookup, and its adjoint.

The JAX package turns small-table lookups into one-hot matmuls to suit
the TPU's layout; on the card a gather is the natural form, so ``cm_take``
is an ``index_select``. ``scatter_rows`` sums per-lane values into the
rows they were gathered from: the backwards of the nearest sweeps and the
fused NEE, whose tables have few rows and whose lanes are many.
"""

from __future__ import annotations

import torch


def cm_take(table_cm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table_cm [C, R] indexed by ``idx`` of any shape -> [C, *idx.shape].
    Where the table requires grad the gather runs under ``TakeColumns``,
    whose backward is ``scatter_rows``."""
    rows = idx.reshape(-1).to(torch.int64)
    if table_cm.requires_grad and torch.is_grad_enabled():
        out = TakeColumns.apply(table_cm, rows)
    else:
        out = table_cm.index_select(1, rows)
    return out.reshape((table_cm.shape[0],) + tuple(idx.shape))


class TakeColumns(torch.autograd.Function):
    """``table_cm.index_select(1, rows)`` whose backward sums the lanes'
    gradients into the table's columns by ``scatter_rows`` instead of
    ``index_add_``, whose atomics contend on a small table's few
    addresses."""

    @staticmethod
    def forward(ctx, table_cm, rows):
        ctx.save_for_backward(rows)
        ctx.n_rows = table_cm.shape[1]
        return table_cm.index_select(1, rows)

    @staticmethod
    def backward(ctx, grad):
        (rows,) = ctx.saved_tensors
        return scatter_rows(grad.T, rows, ctx.n_rows).T, None


def scatter_rows(values: torch.Tensor, rows: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """values [N, C] summed into rows[i] of a zero [n_rows, C] table, by one
    weighted ``bincount`` over (row, column) bins: on the card a histogram
    in shared memory where the table fits, where autograd's indexing
    backward sorts the lanes and sums each row's serially, and
    ``index_add_`` contends on a few addresses (PERF.md, PR 10). Float
    sums in the order the device takes them; on the CPU one serial pass.
    On the card ``bincount`` reads the bins' min and max back to the host
    to size its output: two stream syncs a call."""
    c = values.shape[1]
    bins = (rows.reshape(-1, 1) * c
            + torch.arange(c, device=rows.device)).reshape(-1)
    return torch.bincount(bins, weights=values.reshape(-1),
                          minlength=n_rows * c).reshape(n_rows, c)
