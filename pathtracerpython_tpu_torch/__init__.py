"""pathtracerpython_tpu_torch — the path tracer in PyTorch, with CUDA kernels.

A port of ``pathtracerpython_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA Hopper card. The layout and names follow the JAX package so each
module's counterpart is easy to find:

- ``scene``    — SDL + OBJ parsing into a padded ``SceneTensors`` dataclass.
- ``ops``      — RNG, camera, sampling and geometry on component-major
                 float32 ``[3, N]`` tensors.
- ``kernels``  — the hand-written CUDA kernels (``csrc/*.cu``): the dense
                 nearest-hit and any-hit sweeps, the fused NEE, and the
                 cluster hierarchy's sparse nearest sweep and walker
                 any-hit, each with its plain PyTorch version, built with
                 ``nvcc`` at first use.
- ``render``   — the wavefront integrator (the fast estimator, dense or
                 through a hierarchy with wavefront sorting for large
                 scenes, and the reference estimator) and image output.
- ``diff``, ``apps`` — gradients, the soft estimator and the fit demos.
- ``utils``, ``cli``, ``viz`` — checkpoints and progressive renders,
                 metrics and profiling; the command line
                 (``python -m pathtracerpython_tpu_torch``); debug views.

The render runs on the device its scene tensors live on: on a CUDA device
the kernels launch; on the CPU their plain versions run. Importing the
package imports nothing heavy.
"""

__version__ = "0.1.0"
