"""The nearest sweeps' share of their roofline: the least time of the
nearest sweeps a unit of work needs (``roofline.sweep_bounds``) over the
device time of the system's nearest-sweep kernels, in %."""

from benchmark import roofline


def read(summary: dict):
    spent = summary["family_s"]["nearest"]
    if spent <= 0.0:
        return None
    need = roofline.sweep_bounds(summary["work"])["nearest"]
    return need * summary["units"] / spent * 100.0
