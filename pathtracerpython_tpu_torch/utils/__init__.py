"""Runtime utilities: checkpoint and resume, metrics, profiling (the JAX
package's ``utils/`` less ``compile_cache.py``: the port compiles nothing
through XLA). Checkpoints are ``torch.save`` state dicts where the JAX
package writes orbax pytrees; metrics time with the device synchronized
(CUDA events on the card); traces come from ``torch.profiler``.
"""

from pathtracerpython_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    render_progressive,
)
from pathtracerpython_tpu_torch.utils.metrics import MetricsLogger, phase_timer
from pathtracerpython_tpu_torch.utils.profiling import trace_context

__all__ = [
    "CheckpointManager",
    "render_progressive",
    "MetricsLogger",
    "phase_timer",
    "trace_context",
]
