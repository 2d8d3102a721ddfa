"""Hand-written CUDA kernels for the hot sweeps, each with its plain
PyTorch version: ``intersect`` (K1 dense nearest hit, K4 dense any-hit),
``nee`` (K2 fused next-event estimation), ``sparse`` (K5 cluster-sparse
nearest hit, K6 cluster-sparse any-hit, K7 the any-hit that reports the
blocking cluster, with the occluder cache's two passes, and the cluster
hierarchy's candidate lists) and ``walker`` (K8 walker nearest hit, K9
walker any-hit). ``build`` compiles ``csrc/*.cu`` at first use."""
