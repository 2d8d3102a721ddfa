"""Batched RNG, camera, sampling and geometry primitives on component-major
float32 [3, N] tensors — the counterparts of the JAX package's ``ops``."""
