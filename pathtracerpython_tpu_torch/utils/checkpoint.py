"""Checkpoint and resume, and progressive rendering, as the JAX package's
``utils/checkpoint.py``, with ``torch.save`` state dicts in orbax's place.

A render's accumulation state (radiance sum, samples and chunks done) is
checkpointed after every chunk, so a stopped render resumes from its last
chunk; the same manager checkpoints a fit's params, optimizer state and
RNG position (``diff/inverse.py:fit``).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Any

import torch

from pathtracerpython_tpu_torch.ops import rng
from pathtracerpython_tpu_torch.utils.metrics import span

_STATE_FILE = "state.pt"


def _to_like(value, template):
    """``value`` with every tensor moved to the device (and floating dtype)
    of the tensor at the same place in ``template``."""
    if isinstance(value, torch.Tensor) and isinstance(template, torch.Tensor):
        dtype = template.dtype if value.is_floating_point() else value.dtype
        return value.to(device=template.device, dtype=dtype)
    if isinstance(value, dict) and isinstance(template, dict):
        return {k: _to_like(v, template[k]) if k in template else v
                for k, v in value.items()}
    if isinstance(value, (list, tuple)) and isinstance(template, (list,
                                                                  tuple)):
        return type(value)(_to_like(v, t) for v, t in zip(value, template))
    return value


class CheckpointManager:
    """Numbered checkpoints under a directory: step k is the directory
    ``step_%08d`` holding one ``torch.save`` file, written under a
    ``.tmp`` name and renamed into place, so a stopped save leaves no step
    behind."""

    def __init__(self, directory: str):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step:08d}")

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` (tensors, numbers and containers of them) as
        step ``step``, replacing one already there."""
        final = self._path(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, _STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)

    def restore(self, step: int, template: Any = None) -> Any:
        """Step ``step``'s state; with a ``template`` (a state of the same
        structure) each tensor comes back on its template tensor's device
        and in its floating dtype, else on the CPU."""
        state = torch.load(os.path.join(self._path(step), _STATE_FILE),
                           map_location="cpu", weights_only=True)
        return state if template is None else _to_like(state, template)

    def latest_step(self) -> int | None:
        steps = []
        for name in os.listdir(self._dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return max(steps) if steps else None


def chunk_seed(seed: int, chunk: int) -> int:
    """The seed of sample chunk ``chunk``: JAX's
    ``randint(fold_in(PRNGKey(seed), chunk), (), 0, 2^31 - 1)``
    (``utils/checkpoint.py:114-116`` of the JAX package), word for word on
    the port's Threefry, so that a chunked render here uses the seeds of
    the JAX package's chunked render."""
    return rng.randint(rng.fold_in(seed, chunk), 0, 2**31 - 1)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_progressive(scene, cfg, total_samples: int, chunk_samples: int,
                       checkpoint_dir: str | None, seed: int = 0,
                       log=print, progress=None, renderer=None):
    """Accumulate ``total_samples`` spp in chunks of ``chunk_samples``,
    checkpointing after each when ``checkpoint_dir`` is given, and resuming
    from the latest checkpoint there (JAX ``utils/checkpoint.py:50-134``).

    Chunk i renders with seed ``chunk_seed(seed, i)``, so for a fixed
    ``chunk_samples`` the result does not depend on how often the job
    stopped: a resumed run bit-matches an uninterrupted one, and a run
    without ``checkpoint_dir`` matches a checkpointed one. Changing
    ``chunk_samples`` changes the chunk-to-seed mapping and so the (equally
    converged) image. When ``chunk_samples`` does not divide
    ``total_samples`` the last chunk still renders ``chunk_samples``: the
    mean is over the samples done. Returns radiance [W*H, 3] on the
    scene's device.

    ``progress(chunk_done, n_chunks, samples_done, seconds)`` is called
    after each chunk, timed with the device synchronized.

    ``renderer(scene, cfg_chunk, seed) -> radiance`` renders a chunk
    (default ``render``; a sharded render such as
    ``parallel.render_sharded`` with its mesh bound, JAX
    ``cli/main.py:253-262``). Under several ranks only rank 0 writes the
    checkpoints, and every rank resumes from them."""
    from pathtracerpython_tpu_torch.parallel.multihost import is_primary
    from pathtracerpython_tpu_torch.render.integrator import render

    if renderer is None:
        renderer = render

    n_chunks = -(-total_samples // chunk_samples)
    cfg_chunk = dataclasses.replace(cfg, n_samples=chunk_samples)
    w, h = scene.meta.width, scene.meta.height
    state = {
        "radiance_sum": torch.zeros((w * h, 3), dtype=torch.float32,
                                    device=scene.device),
        "samples_done": 0,
        "chunks_done": 0,
    }
    mgr = None
    if checkpoint_dir is not None:
        mgr = CheckpointManager(checkpoint_dir)
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(latest, state)
            log(f"resumed at chunk {state['chunks_done']}/{n_chunks}")

    for chunk in range(state["chunks_done"], n_chunks):
        t0 = time.perf_counter()
        with span("ptt.chunk"):
            radiance = renderer(scene, cfg_chunk,
                                seed=chunk_seed(seed, chunk))
            state = {
                "radiance_sum": (state["radiance_sum"]
                                 + radiance * chunk_samples),
                "samples_done": state["samples_done"] + chunk_samples,
                "chunks_done": chunk + 1,
            }
        _synchronize(scene.device)
        dt = time.perf_counter() - t0
        if mgr is not None and is_primary():
            mgr.save(chunk + 1, state)
            log(f"chunk {chunk + 1}/{n_chunks} checkpointed "
                f"({state['samples_done']} spp)")
        if progress is not None:
            progress(chunk + 1, n_chunks, state["samples_done"], dt)

    return state["radiance_sum"] / max(state["samples_done"], 1)
