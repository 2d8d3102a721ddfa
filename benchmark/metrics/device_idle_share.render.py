"""The device's idle share in a render's traced chunks: the seconds no
kernel, copy or fill ran on the card over the traced window's seconds, in %."""


def read(summary: dict):
    if summary["busy_s"] <= 0.0:
        return None
    return (1.0 - summary["busy_s"] / summary["window_s"]) * 100.0
