"""Device milliseconds a chunk of the direct light: the self-time of the
system's ``ptt.nee`` spans (``render/integrator.py:shade``: the shadow rays,
K2, K4, K6, K7 or K9, and the shading around them)."""

from benchmark import spans


def read(summary: dict):
    return spans.self_ms(summary, "ptt.nee", "ptt.chunk")
