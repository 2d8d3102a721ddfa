"""Runtime utilities: checkpoint and resume, metrics, profiling (the JAX
package's ``utils/`` less ``compile_cache.py``: the port compiles nothing
through XLA). Checkpoints are ``torch.save`` state dicts where the JAX
package writes orbax pytrees; metrics time with the device synchronized
(CUDA events on the card); traces come from ``torch.profiler``, under which
alone the package's phase spans and counters record (``metrics.span``).
"""

from pathtracerpython_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    render_progressive,
)
from pathtracerpython_tpu_torch.utils.metrics import MetricsLogger
from pathtracerpython_tpu_torch.utils.profiling import trace_context

__all__ = [
    "CheckpointManager",
    "render_progressive",
    "MetricsLogger",
    "trace_context",
]
