"""The roofline's byte counts of each sweep family by hand at a tiny shape,
the readers' arithmetic, and a trace's summary on a synthetic trace."""

from __future__ import annotations

import pytest

from benchmark import harness, roofline, trace


def test_nearest_bytes_by_hand():
    # 4 rays: origin + direction in (6 floats), t + row out (2 x 4 bytes);
    # 2 triangles of 3 vertices (9 floats)
    assert roofline.nearest_bytes(4, 2) == 4 * (24 + 8) + 2 * 36 == 200


def test_anyhit_bytes_by_hand():
    # 6 shadow rays: origin, direction, distance in (7 floats), a byte out
    assert roofline.anyhit_bytes(6, 2) == 6 * (28 + 1) + 2 * 36 == 246


def test_bound_takes_the_larger_term():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12 / 46) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12 / 46) == pytest.approx(2.0)


def test_sweep_bounds_by_hand():
    work = {"lanes": 8, "bounces": 3, "light_samples": 2, "triangles": 5}
    b = roofline.sweep_bounds(work)
    near = 3 * max((8 * 32 + 5 * 36) / 3.35e12, 8 * 46 / 67e12)
    shadow = 3 * max((16 * 29 + 5 * 36) / 3.35e12, 16 * 46 / 67e12)
    assert b["nearest"] == pytest.approx(near)
    assert b["anyhit"] == pytest.approx(shadow)


def summary(**kw):
    base = {"units": 2, "window_s": 1.0, "busy_s": 0.25,
            "family_s": {"nearest": 0.0, "anyhit": 0.0},
            "port_kernel_s": 0.1, "all_kernel_s": 0.3, "backward_s": 0.0,
            "work": {"lanes": 1 << 20, "bounces": 4, "light_samples": 3,
                     "triangles": 36}}
    base.update(kw)
    return base


def test_readers():
    read = harness.metric_reader
    s = summary(family_s={"nearest": 0.002, "anyhit": 0.004},
                backward_s=0.05)
    bounds = roofline.sweep_bounds(s["work"])
    assert read("nearest_roofline")(s) == pytest.approx(
        bounds["nearest"] * 2 / 0.002 * 100)
    assert read("anyhit_roofline")(s) == pytest.approx(
        bounds["anyhit"] * 2 / 0.004 * 100)
    assert read("device_idle_share.render")(s) == pytest.approx(75.0)
    assert read("device_idle_share.fit")(s) == pytest.approx(75.0)
    assert read("torch_kernels_ms.render")(s) == pytest.approx(100.0)
    assert read("backward_ms")(s) == pytest.approx(25.0)
    empty = summary(busy_s=0.0, all_kernel_s=0.0)
    for name in ("nearest_roofline", "anyhit_roofline", "backward_ms",
                 "device_idle_share.render", "torch_kernels_ms.render"):
        assert read(name)(empty) is None


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_summarize_a_synthetic_trace():
    port = {"nearest_kernel", "nee_kernel", "tiny_kernel"}
    events = [
        _x("cpu_op", "aten::mul", 0, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=1),
        _x("cpu_op", "ptt_nearest", 20, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 21, 1, corr=2),
        _x("cpu_op", BACKWARD := trace.BACKWARD_OP + ": MulBackward0",
           40, 20, tid=2),
        _x("cpu_op", "aten::mul", 41, 5, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 42, 1, tid=2, corr=3),
        _x("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
           5, 10, tid=7, corr=1),
        _x("kernel", "void nearest_kernel<(ptt::Form)0>(float const*)",
           25, 20, tid=7, corr=2),
        _x("kernel", "void (anonymous namespace)::tiny_kernel(float const*)",
           60, 5, tid=7, corr=3),
    ]
    s = trace.summarize(events, 100e-6, port)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["all_kernel_s"] == pytest.approx(35e-6)
    assert s["port_kernel_s"] == pytest.approx(25e-6)
    assert s["family_s"]["nearest"] == pytest.approx(20e-6)
    assert s["family_s"]["anyhit"] == 0.0
    assert s["backward_s"] == pytest.approx(5e-6)
    # gaps 15-25 (launched inside ptt_nearest) and 45-60 (inside aten::mul
    # of the backward thread)
    assert s["idle_gaps"] == {"ptt_nearest": pytest.approx(10e-6),
                              "aten::mul": pytest.approx(15e-6)}
    b = trace.breakdown(s)
    assert b["device_ops"][0][0].startswith("void nearest_kernel")
    assert b["idle_gaps"][0] == ["aten::mul", pytest.approx(15e-6)]
    assert BACKWARD.startswith(trace.BACKWARD_OP)


def test_port_kernel_names_from_sources():
    import os

    names = trace.port_kernel_names(os.path.join(harness.ROOT,
                                                 harness.PROGRAM))
    for n in ("nearest_kernel", "nee_kernel", "sparse_nearest_kernel",
              "walker_any_hit_kernel", "narrow_kernel"):
        assert n in names
    assert all(k in names for fam in trace.FAMILIES.values() for k in fam)
