"""Device milliseconds a chunk of the system's Threefry draws: the self-time
of its ``ptt.rng`` spans (``ops/rng.py:uniforms``), from each start event to
its end event, so its kernels and the device's waits for their launches."""

from benchmark import spans


def read(summary: dict):
    return spans.self_ms(summary, "ptt.rng", "ptt.chunk")
