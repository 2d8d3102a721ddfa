"""Multi-process runtime: process-group set-up, the transport every
collective goes through, and result assembly (the JAX package's
``parallel/multihost.py`` on ``torch.distributed``).

Every rank runs the same program. Under ``torchrun``
(``python -m torch.distributed.run --nproc-per-node N ...``)
``initialize()`` reads its environment; a test or a launcher of its own
passes ``init_method``, ``world_size`` and ``rank``. A single process needs
nothing: ``initialize()`` is then a no-op and every sharded entry point
runs on the degenerate mesh of one rank.

The backend is chosen, never fallen back to:

- **NCCL** where every local rank has a GPU of its own (rank r of a host
  drives ``cuda:r``);
- **gloo** on the CPU, and where the ranks share a host's one card: NCCL
  refuses two ranks on one device, so ranks sharing a card talk through
  gloo, and asking for ``backend="nccl"`` there raises. More local ranks
  than cards on a host of several cards raises too. The computation stays on the
  card; only the transfers go through host memory.

All traffic goes through one function, ``transport``. On NCCL it calls the
collective on the device tensors. On gloo it copies each CUDA tensor to a
host buffer, runs the collective on the host buffers and copies the result
back: gloo's send and recv (and so ``batch_isend_irecv``) take CPU tensors
only, while its all_reduce, broadcast and all_gather also take CUDA tensors
and stage them themselves; staging every call in one place keeps one rule
for all of them. Rank 0 prints the backend and the transport on its first
log line.

JAX's ``to_global`` has no counterpart: torch has no global arrays. A
sharded entry point here takes the whole (host-replicated) input on every
rank, slices its own part, and all-gathers the result, so every rank holds
the whole output (``fetch_to_host`` does the same for a rank's own part).
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

# What ``initialize`` chose (backend None: a single process; device None:
# this rank's device is ``default_device(0, 1, platform)``).
_STATE: dict = {"backend": None, "device": None, "staged": False,
                "platform": "auto"}


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def default_device(local_rank: int, local_world: int,
                   platform: str = "auto") -> torch.device:
    """A rank's device: the CPU when ``platform`` is "cpu"; else its own
    card where the host has one per local rank, the one card where the
    host has a single card. Without a card, "auto" and "cuda" raise
    ``RuntimeError``: nothing falls back to the CPU unasked. More local
    ranks than cards, on a host of several cards, raises ``ValueError``:
    ranks would pile onto one card and leave the others idle."""
    if platform not in ("auto", "cuda", "cpu"):
        raise ValueError(f"platform={platform!r}: expected 'auto', 'cuda' "
                         "or 'cpu'")
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the ranks run on the card; pass "
                           "platform='cpu' (or a mesh's device='cpu') to "
                           "run them on the CPU")
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return torch.device("cuda", local_rank)
    if cards == 1:
        return torch.device("cuda", 0)
    raise ValueError(
        f"{local_world} local ranks on a host of {cards} cards: start at "
        f"most {cards} ranks a host (a card each), or one card's worth")


def _shares_card(device: torch.device, local_world: int) -> bool:
    return device.type == "cuda" and local_world > torch.cuda.device_count()


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               backend: str | None = None, platform: str = "auto",
               log=print) -> bool:
    """Join the process group; returns True when more than one rank runs.

    With no arguments, torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``)
    is read; without it, or with a world of one, nothing is initialised.
    ``platform`` ("auto", "cuda" or "cpu") places the rank (see
    ``default_device``), in a world of one too, where it is what
    ``device()`` answers; ``backend`` None chooses NCCL where each local rank
    has a card of its own, else gloo. Calling it again in an initialised
    process returns the answer of the first call."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if world_size is None or world_size <= 1:
        _STATE.update(backend=None, device=None, staged=False,
                      platform=platform)
        return False
    if rank is None:
        raise ValueError("a world of more than one rank needs this rank's "
                         "index (RANK or rank=)")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
    device = default_device(local_rank, local_world, platform)
    shared = _shares_card(device, local_world)
    if backend is None:
        backend = "nccl" if device.type == "cuda" and not shared else "gloo"
    if backend == "nccl" and (device.type != "cuda" or shared):
        raise ValueError(
            f"backend='nccl' needs a card of its own for each rank: "
            f"{local_world} local ranks, {torch.cuda.device_count()} cards "
            f"(device {device}); ranks that share a card use gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    staged = backend == "gloo" and device.type == "cuda"
    _STATE.update(backend=backend, device=device, staged=staged,
                  platform=platform)
    if rank == 0:
        log(f"[parallel] {world_size} ranks, backend {backend}, transport "
            f"{describe_transport()}, rank 0 on {device}")
    return True


def describe_transport() -> str:
    """One phrase for the log: how a collective moves its tensors."""
    if _STATE["backend"] is None:
        return "none (one process)"
    if _STATE["staged"]:
        return ("gloo through host buffers (the ranks share a card; every "
                "transfer copies card -> host -> card)")
    if _STATE["backend"] == "nccl":
        return "nccl on the cards"
    return "gloo on the CPU"


def backend() -> str | None:
    """The backend ``initialize`` chose, None in a single process."""
    return _STATE["backend"]


def device() -> torch.device:
    """This rank's device: the one ``initialize`` chose, else the one of
    the platform it was given (the card, unless it was "cpu"). Without a
    card and without ``platform="cpu"`` it raises ``RuntimeError``."""
    if _STATE["device"] is not None:
        return _STATE["device"]
    return default_device(0, 1, _STATE["platform"])


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return rank() == 0


def transport(kind: str, tensor: torch.Tensor, group=None, *,
              peer: int | None = None, send_to: int | None = None,
              recv_from: int | None = None) -> torch.Tensor:
    """The one place a tensor crosses ranks. ``kind``:

    - "all_gather": the ranks' ``tensor`` (equal shapes) concatenated
      along dim 0 in the group's rank order;
    - "all_reduce": the sum over the group;
    - "broadcast": the group rank ``peer``'s tensor (a global rank);
    - "shift": send ``tensor`` to global rank ``send_to`` and return what
      ``recv_from`` sent (same shape and dtype), both at once;
    - "send" / "recv": to or from global rank ``peer``; "recv" fills a
      tensor shaped and typed as ``tensor``.

    Returns a new tensor on ``tensor``'s device; ``tensor`` is not written.
    On gloo a CUDA tensor goes through a host buffer each way."""
    staged = _STATE["staged"] and tensor.is_cuda
    x = tensor.detach()
    x = x.cpu() if staged else x.contiguous()
    if kind == "all_gather":
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x, group=group)
        out = torch.cat(parts)
    elif kind == "all_reduce":
        out = x if staged else x.clone()
        dist.all_reduce(out, group=group)
    elif kind == "broadcast":
        out = x if staged else x.clone()
        dist.broadcast(out, peer, group=group)
    elif kind == "shift":
        out = torch.empty_like(x)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, send_to, group),
            dist.P2POp(dist.irecv, out, recv_from, group)])
        for w in works:
            w.wait()
    elif kind == "send":
        dist.send(x, peer, group=group)
        return tensor
    elif kind == "recv":
        out = torch.empty_like(x)
        dist.recv(out, peer, group=group)
    else:
        raise ValueError(f"transport kind={kind!r}")
    return out.to(tensor.device) if staged else out


_ALIGN = 8  # bytes: every tensor of a packed message starts aligned


def _padded(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def pack_tensors(tensors) -> torch.Tensor:
    """The tensors' bytes end to end in one uint8 tensor (each padded to 8
    bytes, so that its view back is aligned), so that a transfer of many
    tensors is one message."""
    parts = []
    for t in tensors:
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        parts.append(raw)
        pad = _padded(raw.numel()) - raw.numel()
        if pad:
            parts.append(raw.new_zeros(pad))
    return torch.cat(parts)


def unpack_tensors(buffer: torch.Tensor, templates) -> list[torch.Tensor]:
    """Inverse of ``pack_tensors``: tensors shaped and typed as
    ``templates``, views of ``buffer``."""
    out, at = [], 0
    for t in templates:
        n = t.numel() * t.element_size()
        out.append(buffer[at:at + n].view(t.dtype).reshape(t.shape))
        at += _padded(n)
    return out


def fetch_to_host(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0, on the
    host of every rank; ``x`` itself in a single process."""
    if world_size() == 1:
        return x.detach().cpu()
    return transport("all_gather", x, group).cpu()


def sync() -> None:
    """A barrier over every rank (no-op in a single process)."""
    if world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group (no-op in a single process)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(backend=None, device=None, staged=False, platform="auto")


def launch_hint(n: int, argv=None) -> str:
    """The command line that runs this program's ``argv`` on ``n`` ranks."""
    argv = sys.argv if argv is None else argv
    return (f"python -m torch.distributed.run --standalone "
            f"--nproc-per-node {n} " + " ".join(argv))
