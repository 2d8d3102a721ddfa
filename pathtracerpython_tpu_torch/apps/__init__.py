"""Inverse-rendering applications built on ``diff.fit``: recover the Cornell
walls' albedos (and the light's color) from a rendered target image."""
