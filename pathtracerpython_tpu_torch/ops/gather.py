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
# the kernel's constants (csrc/scatter_rows.cu kThreads, kGrid, kTinySlots,
# kNarrowSlots, kWindow), which fix its paths, its grids and its order of
# adds
THREADS = 256
WARPS = THREADS // 32
GRID = 528
TINY_SLOTS = 32
NARROW_SLOTS = 1024
WINDOW = 32

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # values, strides
    ctypes.c_longlong, ctypes.c_int,                        # n, c
    ctypes.c_void_p, ctypes.c_int,                          # rows, row_bytes
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,         # keys, perm, n_rows
    ctypes.c_void_p, ctypes.c_longlong,                     # part, its len
    ctypes.c_void_p, ctypes.c_void_p,                       # row_end, out
    ctypes.c_int, ctypes.c_void_p,                          # device, stream
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


def plan(n: int, c: int, n_rows: int) -> tuple[str, int, int]:
    """The kernel's path and grid for N lanes of C columns onto n_rows
    rows, from those three alone: ("tiny" | "narrow" | "wide", narrow
    blocks, rounds of THREADS lanes a block)."""
    slots = n_rows * c
    path = ("tiny" if slots <= TINY_SLOTS else
            "narrow" if slots <= NARROW_SLOTS else "wide")
    rounds = -(-n // THREADS)
    rpb = max(1, -(-rounds // GRID))
    return path, -(-rounds // rpb), rpb


def _tree(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The halving tree over ``dim`` (a power of two long), x[i] + x[i + h]:
    a warp's shuffle-down tree and the kernel's tree over its warps."""
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def _add_lanes(acc, lane, keys, values, n_rows):
    """acc[i, keys[lane[i]] * C + j] += values[lane[i], j] in float32, for
    every accumulator i whose lane is a lane (< N) of a row of the table."""
    n, c = values.shape
    ok = lane < n
    at = lane.clamp_max(n - 1)
    k = keys[at]
    ok &= (k >= 0) & (k < n_rows)
    col = (k.clamp(0, n_rows - 1) * c)[:, None] + torch.arange(
        c, device=values.device)
    cur = acc.gather(1, col)
    acc.scatter_(1, col, torch.where(ok[:, None],
                                     cur + values.index_select(0, at), cur))


def _narrow_partials(values, keys, n_rows, path, blocks, rpb):
    """[blocks, n_rows * C]: each narrow block's partial table. Tiny: each
    thread adds its lanes serially into its own slots, then the warp's tree
    and the tree over the block's warps. Narrow: each warp adds its lanes
    serially, round by round and within a round in lane order, into its
    own table, then the tree over the block's warps."""
    n, c = values.shape
    dev = values.device
    first = torch.arange(blocks, device=dev)[:, None] * rpb * THREADS
    if path == "tiny":
        base = (first + torch.arange(THREADS, device=dev)).reshape(-1)
        acc = torch.zeros((base.numel(), n_rows * c), device=dev)
        for q in range(rpb):
            _add_lanes(acc, base + q * THREADS, keys, values, n_rows)
        warps = _tree(acc.reshape(blocks, WARPS, 32, -1), 2)
        return _tree(warps, 1)
    base = (first + 32 * torch.arange(WARPS, device=dev)).reshape(-1)
    acc = torch.zeros((base.numel(), n_rows * c), device=dev)
    for q in range(rpb):
        for lane in range(32):
            _add_lanes(acc, base + q * THREADS + lane, keys, values, n_rows)
    return _tree(acc.reshape(blocks, WARPS, -1), 1)


def _grid_tree(part: torch.Tensor) -> torch.Tensor:
    """[blocks, S] -> [S]: lane j of an entry's warp adds the partials of
    blocks j, j + 32, ... serially, then the warp's tree."""
    blocks = part.shape[0]
    lanes = torch.zeros((32, part.shape[1]), device=part.device)
    for b0 in range(0, blocks, 32):
        got = part[b0:b0 + 32]
        lanes[:got.shape[0]] = lanes[:got.shape[0]] + got
    return _tree(lanes, 0)


def _wide_order(values, rows, n_rows):
    """The wide path: the rows sorted stably; each window of WINDOW sorted
    positions scanned by runs of equal keys (Hillis-Steele, offsets 1 to
    16); a row inside one window is its run's sum; a longer one the sum of
    its windows' partials (the first window's tail, then each later
    window's head), lane j of its warp adding partials j, j + 32, ...
    serially, then the warp's tree."""
    n, c = values.shape
    dev = values.device
    out = torch.zeros((n_rows, c), dtype=torch.float32, device=dev)
    keys, perm = torch.sort(rows.reshape(-1).to(torch.int32), stable=True)
    windows = -(-n // WINDOW)
    pad = windows * WINDOW - n
    k = torch.cat([keys.to(torch.int64),
                   keys.new_full((pad,), -2**40, dtype=torch.int64)])
    in_table = (k >= 0) & (k < n_rows)
    v = torch.cat([values.index_select(0, perm), values.new_zeros((pad, c))])
    v = torch.where(in_table[:, None], v, 0.0).reshape(windows, WINDOW, c)
    k2, in2 = k.reshape(windows, WINDOW), in_table.reshape(windows, WINDOW)
    lane = torch.arange(WINDOW, device=dev)
    new_run = torch.ones_like(in2)
    new_run[:, 1:] = k2[:, 1:] != k2[:, :-1]
    head = torch.cummax(torch.where(new_run, lane, 0), dim=1).values
    x = v
    off = 1
    while off < WINDOW:
        take = (lane[off:] - off >= head[:, off:])[..., None]
        x = torch.cat([x[:, :off], torch.where(take, x[:, :-off] + x[:, off:],
                                               x[:, off:])], dim=1)
        off *= 2
    run_end = torch.ones_like(in2)
    run_end[:, :-1] = k2[:, :-1] != k2[:, 1:]
    # the row goes on past the window's last lane; it began before its first
    after = torch.cat([k[WINDOW:], k.new_full((1,), -2**41)])[::WINDOW]
    goes_on = k2[:, -1] == after
    before = torch.cat([k.new_full((1,), -2**41), k[WINDOW - 1:-1:WINDOW]])
    starts0 = k2[:, 0] != before
    goes_on_lane = torch.zeros_like(in2)
    goes_on_lane[:, -1] = goes_on
    whole = (((head > 0) | starts0[:, None]) & ~goes_on_lane & run_end
             & in2)
    out[k2[whole]] = x[whole]
    head_part = x[torch.arange(windows, device=dev),
                  torch.argmax(run_end.to(torch.int8), dim=1)]
    tail_part = x[:, -1]
    ids = torch.arange(n_rows, dtype=torch.int32, device=dev)
    s = torch.searchsorted(keys, ids).to(torch.int64)
    e = torch.searchsorted(keys, ids, right=True).to(torch.int64)
    long_rows = torch.nonzero((e > s) & ((e - 1) // WINDOW > s // WINDOW)
                              ).flatten()
    if long_rows.numel():
        ws = s[long_rows] // WINDOW
        m = (e[long_rows] - 1) // WINDOW - ws + 1
        acc = torch.zeros((long_rows.numel(), 32, c), device=dev)
        for i0 in range(0, int(m.max()), 32):
            i = i0 + lane[None]
            at = (ws[:, None] + i).clamp_max(windows - 1)
            got = torch.where((i == 0)[..., None], tail_part[at],
                              head_part[at])
            acc = torch.where((i < m[:, None])[..., None], acc + got, acc)
        out[long_rows] = _tree(acc, 1)
    return out


def scatter_rows_model(values: torch.Tensor, rows: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """The kernel's order in plain PyTorch, to its last bit: the same
    float32 adds in the same association as csrc/scatter_rows.cu on the
    path and grid that ``plan`` gives (its constants are ``THREADS``,
    ``GRID``, ``TINY_SLOTS``, ``NARROW_SLOTS`` and ``WINDOW``). The card's
    checks hold the kernel to it bit for bit; the CPU tests hold it to the
    float64 sum. Nothing on a render or training path calls it."""
    n, c = values.shape
    if n == 0 or c == 0 or n_rows == 0:
        return torch.zeros((n_rows, c), dtype=torch.float32,
                           device=values.device)
    path, blocks, rpb = plan(n, c, n_rows)
    if path == "wide":
        return _wide_order(values, rows, n_rows)
    part = _narrow_partials(values, rows.reshape(-1).to(torch.int64), n_rows,
                            path, blocks, rpb)
    return _grid_tree(part).reshape(n_rows, c)


def scatter_rows_cuda(values: torch.Tensor, rows: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """Launch csrc/scatter_rows.cu on ``values`` [N, C] float32 (any
    strides, read in place) and ``rows`` [N] of an integer type on one CUDA
    device. A narrow table (n_rows * C <= NARROW_SLOTS) takes no sort: the
    kernel reads the rows as they are (int32 or int64; another type is
    cast to int32). A wide one sorts them stably as int32 keys
    (``torch.sort``, the permutation fixed by the rows) first. No host
    read; N = 0 or C = 0 launches nothing."""
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
    if n_rows * c > _INT_MAX:
        raise ValueError(f"scatter_rows_cuda: a table of {n_rows} rows x {c} "
                         "past the kernel's int32 keys")
    out = torch.empty((n_rows, c), dtype=torch.float32, device=values.device)
    if n == 0 or c == 0 or n_rows == 0:
        return out.zero_()
    path, blocks, rpb = plan(n, c, n_rows)
    rows = rows.reshape(-1)
    keys = perm = row_end = None
    if path == "wide":
        keys, perm = torch.sort(rows.to(torch.int32), stable=True)
        part = torch.empty(2 * c * -(-n // WINDOW), dtype=torch.float32,
                           device=values.device)
        row_end = torch.empty(n_rows, dtype=torch.int64, device=values.device)
        rows = None
    else:
        if rows.dtype not in (torch.int32, torch.int64):
            rows = rows.to(torch.int32)
        rows = rows.contiguous()
        part = torch.empty(n_rows * c * blocks, dtype=torch.float32,
                           device=values.device)
    fn = build.function("ptt_scatter_rows", _ARGTYPES)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = fn(values.data_ptr(), values.stride(0), values.stride(1), n, c,
             0 if rows is None else rows.data_ptr(),
             0 if rows is None else rows.element_size(),
             0 if keys is None else keys.data_ptr(),
             0 if perm is None else perm.data_ptr(), n_rows,
             part.data_ptr(), part.numel(),
             0 if row_end is None else row_end.data_ptr(), out.data_ptr(),
             values.device.index, stream)
    if err != 0:
        raise RuntimeError(f"ptt_scatter_rows: kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
