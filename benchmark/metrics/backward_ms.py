"""Device milliseconds a training step of the kernels launched from inside
autograd's backward (the re-solves, the NEE's smooth cosine, the table
sums and the glue's gradients)."""


def read(summary: dict):
    if summary["backward_s"] <= 0.0:
        return None
    return summary["backward_s"] / summary["units"] * 1e3
