"""Hand-written CUDA kernels for the hot sweeps, each with its plain
PyTorch version: ``intersect`` (K1, dense nearest hit) and ``nee`` (K2,
fused next-event estimation). ``build`` compiles ``csrc/*.cu`` at first
use."""
