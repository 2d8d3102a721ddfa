"""Offline debug views (the JAX package's ``viz/``; the reference's
interactive viewer, ``plot.py``, needs a display)."""

from pathtracerpython_tpu_torch.viz.plot import plot_scene

__all__ = ["plot_scene"]
