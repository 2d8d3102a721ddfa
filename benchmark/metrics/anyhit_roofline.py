"""The shadow sweeps' share of their roofline: the least time of the
any-hit sweeps of a unit's shadow rays (``roofline.sweep_bounds``) over the
device time of the system's NEE and any-hit kernels, in %."""

from benchmark import roofline


def read(summary: dict):
    spent = summary["family_s"]["anyhit"]
    if spent <= 0.0:
        return None
    need = roofline.sweep_bounds(summary["work"])["anyhit"]
    return need * summary["units"] / spent * 100.0
