"""Device milliseconds a chunk of the nearest sweeps: the self-time of the
system's ``ptt.nearest`` spans (``ops/geometry.py:nearest_hit_cm``: the
candidate lists, K1, K5 or K8, and the plain sweeps of reference mode)."""

from benchmark import spans


def read(summary: dict):
    return spans.self_ms(summary, "ptt.nearest", "ptt.chunk")
