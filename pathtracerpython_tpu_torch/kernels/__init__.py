"""Hand-written CUDA kernels for the hot sweeps, each with its plain
PyTorch version: ``intersect`` (K1 dense nearest hit, K4 dense any-hit),
``nee`` (K2 fused next-event estimation), ``sparse`` (K5 cluster-sparse
nearest hit, and the cluster hierarchy's candidate lists) and ``walker``
(K9 walker any-hit). ``build`` compiles ``csrc/*.cu`` at first use."""
