"""Command-line interface (the JAX package's ``cli/``, a drop-in for the
reference's ``./main.py`` CLI)."""

from pathtracerpython_tpu_torch.cli.main import main

__all__ = ["main"]
