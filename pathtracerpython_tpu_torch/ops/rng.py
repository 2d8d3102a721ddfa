"""Dense counter-based RNG (Threefry-2x32), bit-equal to ``ops/rng.py`` of
the JAX package.

Keys are pairs of Python ints; per-ray streams hash dense counter tensors
(the GLOBAL path id), so a draw depends only on the key and the counter,
never on the lane it lands in. ``uniforms`` on a CUDA tensor launches the
kernel of csrc/threefry.cu (``uniforms_cuda``), which hashes in uint32
registers; on a CPU tensor it runs the plain version (``uniforms_plain``),
the same bits. PyTorch has no shifts on uint32, so there 32-bit words ride
in int64 tensors masked to 32 bits after every step that can carry past
them. The same code runs on Python ints, which is how keys are derived
(``fold``) without touching the device.

Threefry-2x32 (Salmon et al. 2011, "Parallel random numbers: as easy as
1, 2, 3") with the standard 20 rounds.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracerpython_tpu_torch.kernels import build
from pathtracerpython_tpu_torch.utils.metrics import span

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF
_FOLD_WORD = 0x736F6C74

# launches of csrc/threefry.cu, one a call of ``uniforms`` on the card
LAUNCHES = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,  # counters, stride, bytes
    ctypes.c_longlong, ctypes.c_int,                   # n, n_draws
    ctypes.c_uint, ctypes.c_uint,                      # k0, k1
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,    # out, device, stream
]


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """Hash counter words (x0, x1) under key (k0, k1). Keys are ints in
    [0, 2^32); x0/x1 are ints or int64 tensors holding 32-bit words,
    broadcastable. Returns (y0, y1) of the same kinds."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for block in range(5):
        rots = _ROT[0:4] if block % 2 == 0 else _ROT[4:8]
        for r in rots:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK
    return x0, x1


def key_from_seed(seed) -> tuple[int, int]:
    """(k0, k1) from an int seed, the pair ``jax.random.PRNGKey(seed)``
    holds, (seed >> 32, seed & 0xffffffff); or from a key, a pair of ints
    as ``split`` returns (or a tensor of two words), which is what the JAX
    package's ``key_from_seed`` reads from a ``PRNGKey``."""
    if isinstance(seed, (tuple, list, torch.Tensor)):
        k0, k1 = (int(k) for k in seed)
        return k0 & _MASK, k1 & _MASK
    s = int(seed)
    return (s >> 32) & _MASK, s & _MASK


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """``num`` new keys from ``key`` (an int seed or a (k0, k1) pair), the
    words ``jax.random.split`` gives under ``jax_threefry_partitionable``
    (JAX's default from 0.5): key i is threefry(key, (0, i)), i < 2^32."""
    k0, k1 = key_from_seed(key)
    return [threefry2x32(k0, k1, 0, i) for i in range(num)]


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for a threefry key: the hash of
    the counter pair (0, data) under the key (JAX's ``threefry_fold_in``
    hashes ``threefry_seed(uint32(data))``). ``key``: an int seed or a
    (k0, k1) pair."""
    k0, k1 = key_from_seed(key)
    return threefry2x32(k0, k1, 0, int(data) & _MASK)


def randint(key, minval: int, maxval: int) -> int:
    """``int(jax.random.randint(key, (), minval, maxval))`` for int32, word
    for word as JAX 0.9 computes it under ``jax_threefry_partitionable``:
    split the key in two; from each, 32 random bits, the xor of the hash of
    (0, 0); then minval + (hi % span * m + lo % span) % span, where
    m = (2^16 % span)^2 % span in 32-bit arithmetic and span =
    maxval - minval (1 when maxval <= minval). ``minval`` and ``maxval``
    lie in int32."""
    imin, imax = -2**31, 2**31 - 1
    if not (imin <= minval <= imax and imin <= maxval <= imax):
        raise ValueError("randint bounds must lie in int32")
    span = (maxval - minval) & _MASK if maxval > minval else 1

    def bits(k):
        y0, y1 = threefry2x32(k[0], k[1], 0, 0)
        return y0 ^ y1

    higher, lower = (bits(k) for k in split(key))
    multiplier = (2**16 % span) & _MASK
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + lower % span
    offset = (offset & _MASK) % span
    value = (minval + offset) & _MASK
    return value - 2**32 if value > imax else value


def fold(k0: int, k1: int, salt: int) -> tuple[int, int]:
    """Derive a sub-key: hash the salt under the parent key."""
    return threefry2x32(k0, k1, int(salt) & _MASK, _FOLD_WORD)


def _to_unit_interval(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) -> float32 in [0, 1): set mantissa, subtract 1."""
    f = (bits >> 9) | 0x3F800000
    return f.to(torch.int32).view(torch.float32) - 1.0


def uniforms(k0: int, k1: int, counters: torch.Tensor, n_draws: int):
    """[n_draws, *counters.shape] float32 uniforms in [0, 1).

    Draws 2k and 2k+1 for counter c are the (y0, y1) outputs of the single
    hash threefry(key, (c, k)). ``counters``: integer tensor of 32-bit
    path ids. On a CUDA tensor the kernel of csrc/threefry.cu
    (``uniforms_cuda``), on a CPU tensor ``uniforms_plain``: the same
    bits."""
    with span("ptt.rng"):
        if counters.device.type == "cpu":
            return uniforms_plain(k0, k1, counters, n_draws)
        return uniforms_cuda(k0, k1, counters, n_draws)


def uniforms_plain(k0: int, k1: int, counters: torch.Tensor, n_draws: int):
    """The plain version of ``uniforms``: the hash as int64 tensor ops."""
    c = counters.to(torch.int64) & _MASK
    out = []
    for d in range(0, n_draws, 2):
        y0, y1 = threefry2x32(k0, k1, c, d >> 1)
        out.append(_to_unit_interval(y0))
        if d + 1 < n_draws:
            out.append(_to_unit_interval(y1))
    return torch.stack(out, dim=0)


def uniforms_cuda(k0: int, k1: int, counters: torch.Tensor, n_draws: int):
    """Launch csrc/threefry.cu: ``uniforms`` for int32 or int64
    ``counters`` on one CUDA device, any strides, read in place (their low
    32 bits). Allocates the [n_draws, *counters.shape] output and fills
    every entry; no host read; no counters launch nothing."""
    global LAUNCHES
    if counters.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"uniforms_cuda: counters {counters.dtype}, "
                         "expected int32 or int64")
    if n_draws < 1:
        raise ValueError(f"uniforms_cuda: n_draws {n_draws}, at least 1")
    if counters.device.type != "cuda":
        raise ValueError(f"uniforms_cuda: counters on {counters.device}, "
                         "not on a card")
    out = torch.empty((n_draws, *counters.shape), dtype=torch.float32,
                      device=counters.device)
    n = counters.numel()
    if n == 0:
        return out
    c = counters.reshape(-1)
    fn = build.function("ptt_threefry_uniforms", _ARGTYPES)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    err = fn(c.data_ptr(), c.stride(0), c.element_size(), n, n_draws,
             k0 & _MASK, k1 & _MASK, out.data_ptr(), c.device.index, stream)
    if err != 0:
        raise RuntimeError(f"ptt_threefry_uniforms: kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES += 1
    return out
