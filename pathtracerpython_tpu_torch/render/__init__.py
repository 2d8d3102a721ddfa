"""Wavefront integrator: flat ray SoA, per-bounce intersect -> shade ->
scatter, on the device the scene lives on."""
