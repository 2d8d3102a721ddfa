"""Row lookups, and their adjoint.

The JAX package turns small-table lookups into one-hot matmuls to suit
the TPU's layout; on the card a gather is the natural form, so ``cm_take``
is an ``index_select``. ``scatter_rows`` sums per-lane values into the
rows they were gathered from: the table gradient of every lookup whose
table requires grad (``cm_take``, ``take_rows``) and of the backwards of
the nearest sweeps and the fused NEE, whose tables have few rows and whose
lanes are many. On the card it is the kernel of ``csrc/scatter_rows.cu``,
which sums in an order fixed by its inputs, so a gradient has the same bits
on every run; on the CPU its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracerpython_tpu_torch.kernels import build

# launches of csrc/scatter_rows.cu, one a call
LAUNCHES = 0
# the kernel's constants (csrc/scatter_rows.cu kRun, kTinyRows,
# kTinyThreads, kRowThreads), which fix its order of adds
RUN = 32
TINY_ROWS = 256
TINY_THREADS = 1024
ROW_THREADS = 256

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,         # values, n, c
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,      # keys, perm, n_rows
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # partial, bounds, out
    ctypes.c_int, ctypes.c_void_p,                       # device, stream
]
_INT_MAX = 2**31 - 1


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


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a row-major table [R, ...] and ``idx`` of any
    shape -> [*idx.shape, ...] (JAX ``ops/gather.py:take_rows``). Where the
    table requires grad the gather runs under ``TakeRows``, whose backward
    is ``scatter_rows``."""
    rows = idx.reshape(-1).to(torch.int64)
    if table.requires_grad and torch.is_grad_enabled():
        out = TakeRows.apply(table, rows)
    else:
        out = table.index_select(0, rows)
    return out.reshape(tuple(idx.shape) + tuple(table.shape[1:]))


class TakeColumns(torch.autograd.Function):
    """``table_cm.index_select(1, rows)`` whose backward sums the lanes'
    gradients into the table's columns by ``scatter_rows`` instead of
    ``index_add_``, whose float atomics add in the schedule's order."""

    @staticmethod
    def forward(ctx, table_cm, rows):
        ctx.save_for_backward(rows)
        ctx.n_rows = table_cm.shape[1]
        return table_cm.index_select(1, rows)

    @staticmethod
    def backward(ctx, grad):
        (rows,) = ctx.saved_tensors
        return scatter_rows(grad.T, rows, ctx.n_rows).T, None


class TakeRows(torch.autograd.Function):
    """``table.index_select(0, rows)`` whose backward is ``scatter_rows``
    over the table's rows flattened to [R, C] (not indexing's
    ``index_put_(accumulate=True)``)."""

    @staticmethod
    def forward(ctx, table, rows):
        ctx.save_for_backward(rows)
        ctx.shape = table.shape
        return table.index_select(0, rows)

    @staticmethod
    def backward(ctx, grad):
        (rows,) = ctx.saved_tensors
        flat = grad.reshape(rows.shape[0], -1)
        return scatter_rows(flat, rows, ctx.shape[0]).reshape(ctx.shape), None


def scatter_rows(values: torch.Tensor, rows: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """values [N, C] float32 summed into rows[i] of a zero [n_rows, C]
    table; every row in [0, n_rows). On a CUDA tensor the kernel of
    csrc/scatter_rows.cu (``scatter_rows_cuda``), on a CPU tensor
    ``scatter_rows_plain``."""
    if values.device.type == "cpu":
        return scatter_rows_plain(values, rows, n_rows)
    return scatter_rows_cuda(values, rows, n_rows)


def scatter_rows_plain(values: torch.Tensor, rows: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """The plain version: one weighted ``bincount`` over (row, column)
    bins, summed in float64 and rounded once to ``values``' type, so within
    half an ulp of the exact sum whatever order the adds take (on the CPU
    one serial pass in lane order; on the card float atomics, and a host
    read of the bins' range: only the card's checks of the kernel call it
    there)."""
    c = values.shape[1]
    bins = (rows.reshape(-1, 1) * c
            + torch.arange(c, device=rows.device)).reshape(-1)
    return torch.bincount(bins, weights=values.reshape(-1).double(),
                          minlength=n_rows * c).to(values.dtype).reshape(
                              n_rows, c)


def scatter_rows_model(values: torch.Tensor, rows: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """The kernel's order in plain PyTorch, to its last bit: the same
    float32 adds in the same association as csrc/scatter_rows.cu (its
    ``kRun``, ``kTinyRows`` and block widths are ``RUN``, ``TINY_ROWS``,
    ``TINY_THREADS`` and ``ROW_THREADS``). The card's checks hold the kernel
    to it bit for bit; the CPU tests hold it to the float64 sum. Nothing on
    a render or training path calls it."""
    n, c = values.shape
    out = torch.zeros((n_rows, c), dtype=torch.float32, device=values.device)
    if n == 0 or c == 0 or n_rows == 0:
        return out
    keys, perm = torch.sort(rows.reshape(-1).to(torch.int32), stable=True)
    windows = -(-n // RUN)
    pad = windows * RUN - n
    v = torch.cat([values.index_select(0, perm),
                   values.new_zeros((pad, c))]).reshape(windows, RUN, c)
    k = torch.cat([keys, keys.new_zeros(pad)]).reshape(windows, RUN)
    past = (torch.arange(windows * RUN, device=values.device) >= n
            ).reshape(windows, RUN)
    # level 1: each window's runs of equal keys, serially, each run's sum at
    # its first position
    new = torch.ones_like(past)
    new[:, 1:] = (k[:, 1:] != k[:, :-1]) | past[:, 1:]
    partial = torch.zeros((windows * RUN, c), dtype=torch.float32,
                          device=values.device)
    first = torch.arange(windows, device=values.device) * RUN
    start = first.clone()
    acc = torch.zeros((windows, c), dtype=torch.float32, device=values.device)
    zero = torch.zeros_like(acc)
    for i in range(RUN):
        if i:
            flush = new[:, i]
            partial[start[flush]] = acc[flush]
            start = torch.where(flush, first + i, start)
        acc = torch.where(new[:, i, None], zero + v[:, i], acc + v[:, i])
    partial[start] = acc
    # level 2: each row's partials at its first position and at the
    # multiples of RUN inside it
    ids = torch.arange(n_rows, dtype=torch.int32, device=values.device)
    s = torch.searchsorted(keys, ids).to(torch.int64)
    e = torch.searchsorted(keys, ids, right=True).to(torch.int64)
    count = torch.where(s < e, (e - 1) // RUN - s // RUN + 1, 0)

    def at(r, j):
        pos = torch.where(j == 0, s[r, None], (s[r, None] // RUN + j) * RUN)
        return partial[pos.clamp_max(windows * RUN - 1)]

    def tree(x):                       # [..., lanes, c]: a shuffle-down tree
        while x.shape[-2] > 1:
            h = x.shape[-2] // 2
            x = x[..., :h, :] + x[..., h:, :]
        return x[..., 0, :]

    lane = torch.arange(32, device=values.device)
    short = torch.nonzero((count > 0) & (count <= 32)).flatten()
    got = at(short, lane[None])
    out[short] = tree(torch.where((lane[None] < count[short, None])[..., None],
                                  got, 0.0))
    long_rows = torch.nonzero(count > 32).flatten()
    if long_rows.numel():
        threads = TINY_THREADS if n_rows <= TINY_ROWS else ROW_THREADS
        t = torch.arange(threads, device=values.device)[None]
        acc = torch.zeros((long_rows.numel(), threads, c), dtype=torch.float32,
                          device=values.device)
        for it in range(-(-int(count[long_rows].max()) // threads)):
            j = t + it * threads
            acc = torch.where((j < count[long_rows, None])[..., None],
                              acc + at(long_rows, j), acc)
        warps = tree(acc.reshape(long_rows.numel(), threads // 32, 32, c))
        out[long_rows] = tree(torch.cat([warps, warps.new_zeros(
            (long_rows.numel(), 32 - threads // 32, c))], dim=1))
    return out


def scatter_rows_cuda(values: torch.Tensor, rows: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """Launch csrc/scatter_rows.cu on ``values`` [N, C] float32 (any
    strides; copied row-major) and ``rows`` [N] of an integer type on one
    CUDA device: the rows sorted stably as int32 keys (``torch.sort``, the
    permutation fixed by the rows), then the kernel's two levels of
    fixed-order sums. No host read; N = 0 or C = 0 launches nothing."""
    global LAUNCHES
    if values.device.type != "cuda" or rows.device != values.device:
        raise ValueError(f"scatter_rows_cuda: values on {values.device}, "
                         f"rows on {rows.device}; both must be on one card")
    if values.dim() != 2 or values.dtype != torch.float32:
        raise ValueError(f"scatter_rows_cuda: values {values.dtype} "
                         f"{tuple(values.shape)}, expected float32 [N, C]")
    n, c = values.shape
    if rows.numel() != n or rows.dtype.is_floating_point:
        raise ValueError(f"scatter_rows_cuda: rows {rows.dtype} "
                         f"{tuple(rows.shape)} for {n} lanes")
    if n > _INT_MAX or 2 * n_rows > _INT_MAX:
        raise ValueError(f"scatter_rows_cuda: {n} lanes onto {n_rows} rows "
                         "past the kernel's int32 positions")
    out = torch.empty((n_rows, c), dtype=torch.float32, device=values.device)
    if n == 0 or c == 0 or n_rows == 0:
        return out.zero_()
    keys, perm = torch.sort(rows.reshape(-1).to(torch.int32), stable=True)
    values = values.contiguous()   # each lane's C floats in one line
    partial = torch.empty((n, c), dtype=torch.float32, device=values.device)
    bounds = torch.empty((n_rows, 2), dtype=torch.int32,
                         device=values.device)
    fn = build.function("ptt_scatter_rows", _ARGTYPES)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = fn(values.data_ptr(), n, c, keys.data_ptr(), perm.data_ptr(),
             n_rows, partial.data_ptr(), bounds.data_ptr(), out.data_ptr(),
             values.device.index, stream)
    if err != 0:
        raise RuntimeError(f"ptt_scatter_rows: kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
