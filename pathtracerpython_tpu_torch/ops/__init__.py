"""Batched RNG, camera, sampling, wavefront sorting and geometry primitives
on component-major float32 [3, N] tensors — the counterparts of the JAX
package's ``ops``."""
