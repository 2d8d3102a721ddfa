"""Device milliseconds a chunk of the wavefront sort and park: the self-time of
the system's ``ptt.sort`` spans (``render/integrator.py:sort_and_park``)."""

from benchmark import spans


def read(summary: dict):
    return spans.self_ms(summary, "ptt.sort", "ptt.chunk")
