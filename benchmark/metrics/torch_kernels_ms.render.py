"""Device milliseconds a chunk in kernels that are not the system's own CUDA
kernels: PyTorch's kernels of the RNG, the shading and scattering glue, the
wavefront sort and the candidate lists."""


def read(summary: dict):
    other = summary["all_kernel_s"] - summary["port_kernel_s"]
    if summary["all_kernel_s"] <= 0.0:
        return None
    return other / summary["units"] * 1e3
