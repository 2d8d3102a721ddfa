"""Find the float sums whose order a device may choose.

``SumAudit`` is a dispatch mode that records every float ``index_add``,
``scatter_add``, ``scatter_reduce`` (sum or mean), ``index_reduce``,
``index_put`` with ``accumulate=True``, ``put_`` with ``accumulate=True``,
``embedding_dense_backward`` and weighted ``bincount`` that runs inside it,
the forward's and the backward's alike, and whether two of its lanes meet at
one address of the output. On the card such an op adds with float atomics
in the schedule's order, so where lanes meet the sum's last bits follow the
schedule; where every address is unique by construction (a permutation, a
gather of one column per row) it sums nothing. A checking tool: nothing on a
render or training path uses it, and it never sets
``torch.use_deterministic_algorithms``.

Usage::

    with SumAudit() as audit:
        loss.backward()
    audit.shared   # {(op, site): calls} of the ops that summed lanes into
                   # one address; audit.unique the same for the others

``site`` is the autograd node that ran the op (its forward's line in the
package under ``torch.autograd.detect_anomaly``), or the package's line that
called it in the forward.
"""

from __future__ import annotations

import collections
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PACKAGE = "pathtracerpython_tpu_torch"
SUMMING_OPS = ("index_add", "index_add_", "scatter_add", "scatter_add_",
               "scatter_reduce", "scatter_reduce_", "index_reduce",
               "index_reduce_", "index_put", "index_put_", "_index_put_impl_",
               "_unsafe_index_put", "put", "put_", "bincount",
               "embedding_dense_backward")


def _along(self: torch.Tensor, dim: int, index: torch.Tensor):
    """The addresses a scatter along ``dim`` writes: each element of
    ``index`` at its own position, with ``dim`` replaced by its value."""
    dim = dim % max(index.dim(), 1)
    addr = index.to(torch.int64) * self.stride(dim)
    for d, size in enumerate(index.shape):
        if d != dim:
            view = [1] * index.dim()
            view[d] = size
            addr = addr + torch.arange(size, device=index.device).reshape(
                view) * self.stride(d)
    return addr.reshape(-1)


def _put_addresses(self: torch.Tensor, indices) -> torch.Tensor:
    """Addresses of ``self[indices]`` (advanced indices; a bool mask is its
    nonzero positions, a None keeps its dim)."""
    tensors, dims = [], []
    d = 0
    for idx in indices:
        if idx is None:
            d += 1
            continue
        if idx.dtype == torch.bool:
            for col in torch.nonzero(idx).unbind(1):
                tensors.append(col)
                dims.append(d)
                d += 1
            continue
        tensors.append(idx)
        dims.append(d)
        d += 1
    tensors = torch.broadcast_tensors(*tensors)
    addr = sum(t.to(torch.int64) * self.stride(k)
               for t, k in zip(tensors, dims))
    return addr.reshape(-1)


def destinations(name: str, args, kwargs) -> torch.Tensor | None:
    """The output addresses an op of SUMMING_OPS adds its lanes into (with
    repeats), or None if it sums no float."""
    self = args[0]
    if name == "bincount":
        weights = kwargs.get("weights", args[1] if len(args) > 1 else None)
        return self.reshape(-1) if weights is not None and \
            weights.is_floating_point() else None
    if name == "embedding_dense_backward":
        return args[1].reshape(-1)
    if not self.is_floating_point():
        return None
    if name.startswith(("index_add", "index_reduce")):
        return args[2].reshape(-1)
    if name.startswith("scatter"):
        if name.startswith("scatter_reduce"):
            reduce = kwargs.get("reduce", args[4] if len(args) > 4 else None)
            if reduce not in ("sum", "mean"):
                return None
        return _along(self, args[1], args[2])
    if name.startswith("put"):
        acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        return args[1].reshape(-1) if acc else None
    acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
    return _put_addresses(self, args[1]) if acc else None


def _site() -> str:
    node = torch._C._current_autograd_node()
    if node is not None:
        site = type(node).__name__
        trace = node.metadata.get("traceback_", "")
        trace = "".join(trace) if isinstance(trace, list) else trace
        lines = [ln.strip() for ln in trace.splitlines() if PACKAGE in ln]
        if lines:
            site += " <- " + lines[-1].split(PACKAGE + "/")[-1]
        return site
    frames = [f for f in traceback.extract_stack()
              if PACKAGE in f.filename and "utils/determinism" not in
              f.filename]
    if not frames:
        return "forward"
    f = frames[-1]
    return f"forward {f.filename.split(PACKAGE + '/')[-1]}:{f.lineno}"


class SumAudit(TorchDispatchMode):
    """Record the float sums of SUMMING_OPS that run inside the mode:
    ``shared`` for those where two lanes meet at one address, ``unique``
    for those whose addresses are distinct; ``ops`` counts every op the
    mode saw, ``backward_ops`` those run by an autograd node."""

    def __init__(self):
        super().__init__()
        self.shared = collections.Counter()
        self.unique = collections.Counter()
        self.ops = 0
        self.backward_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        if torch._C._current_autograd_node() is not None:
            self.backward_ops += 1
        name = func.overloadpacket.__name__
        if name in SUMMING_OPS:
            addr = destinations(name, args, kwargs)
            if addr is not None:
                meet = addr.numel() != torch.unique(addr).numel()
                (self.shared if meet else self.unique)[(name, _site())] += 1
        return func(*args, **kwargs)

    def report(self) -> dict:
        """JSON-ready: the shared and unique sums as "op @ site": calls."""
        return {kind: {f"{op} @ {site}": n for (op, site), n in
                       sorted(getattr(self, kind).items())}
                for kind in ("shared", "unique")} | {
                    "ops": self.ops, "backward_ops": self.backward_ops}
