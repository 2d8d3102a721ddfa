"""Device milliseconds a training step of the system's Threefry draws: the
self-time of its ``ptt.rng`` spans (``ops/rng.py:uniforms``) in the traced
steps."""

from benchmark import spans


def read(summary: dict):
    return spans.self_ms(summary, "ptt.rng", "ptt.step")
