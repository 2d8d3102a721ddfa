"""The port's own spans and counters (``utils/metrics.py``: ``span``,
``count``, ``report``) on the CPU: nothing is recorded, annotated or
reduced while no profiler records; under ``torch.profiler`` a progressive
render and a training step record their phases with their parents and
counts, the lane counters equal the live lanes, the radiance keeps its
bits, and each profiled stretch stands alone."""

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathtracerpython_tpu_torch.diff import adam, make_train_step
from pathtracerpython_tpu_torch.ops import rng
from pathtracerpython_tpu_torch.render import integrator
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from pathtracerpython_tpu_torch.utils import metrics, render_progressive

BOUNCES = 3
CHUNKS = 2
CHUNK_SPP = 2
SIDE = 8
LANES = SIDE * SIDE * CHUNK_SPP
# span -> (its parent, how many a chunk)
RENDER_SPANS = {
    "ptt.chunk": (None, 1),
    "ptt.camera": ("ptt.chunk", 1),
    "ptt.bounce": ("ptt.chunk", BOUNCES),
    "ptt.sort": ("ptt.bounce", BOUNCES),
    "ptt.rng": ("ptt.bounce", 2 * BOUNCES),
    "ptt.nearest": ("ptt.bounce", BOUNCES),
    "ptt.nee": ("ptt.bounce", BOUNCES),
    "ptt.scatter": ("ptt.bounce", BOUNCES),
}
quiet = lambda *a: None  # noqa: E731


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the time of a test alone and
    leaves the other test workers their cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _closed_stretch():
    """Every test starts after the last stretch was closed."""
    metrics.report()
    yield


@pytest.fixture(scope="module")
def scene():
    return arrays.pack_scene(synthetic.cornell_box_scene(SIDE, SIDE),
                             pad_to=32, device="cpu")


def _cfg(mode="fast"):
    return RenderConfig(mode=mode, accel="none", n_samples=CHUNKS * CHUNK_SPP,
                        n_bounces=BOUNCES, batch_samples=True)


def _progressive(scene, mode="fast"):
    return render_progressive(scene, _cfg(mode), CHUNKS * CHUNK_SPP,
                              CHUNK_SPP, None, seed=5, log=quiet)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def test_no_profiler_records_nothing(scene, monkeypatch):
    """No CUDA event, no ``record_function``, no counter, no reduction of
    the counters' while no profiler records; under one, one reduction a
    bounce."""
    made = {"event": 0, "annotation": 0, "sum": 0}

    class Event:
        def __init__(self, *a, **k):
            made["event"] += 1

    real_fn, real_sum = torch.profiler.record_function, torch.Tensor.sum

    def annotation(*a, **k):
        made["annotation"] += 1
        return real_fn(*a, **k)

    def counted_sum(self, *a, **k):
        made["sum"] += 1
        return real_sum(self, *a, **k)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.profiler, "record_function", annotation)
    monkeypatch.setattr(torch.Tensor, "sum", counted_sum)
    assert metrics.span("ptt.chunk") is metrics.span("ptt.rng")
    _progressive(scene)
    assert made["event"] == made["annotation"] == 0
    assert metrics.RECORDER.spans == [] and metrics.RECORDER.counts == []
    plain_sums = made["sum"]
    made["sum"] = 0
    _profiled(lambda: _progressive(scene))
    assert made["sum"] == plain_sums + CHUNKS * BOUNCES
    assert made["annotation"] == sum(n for _, n in RENDER_SPANS.values()
                                     ) * CHUNKS
    assert made["event"] == 0   # the host clock off the card


@pytest.mark.parametrize("mode", ["fast", "reference"])
def test_profiled_render_records_the_phases(scene, mode):
    _profiled(lambda: _progressive(scene, mode))
    spans = list(metrics.RECORDER.spans)
    rep = metrics.report()
    assert set(rep["spans"]) == set(RENDER_SPANS)
    for name, (parent, per_chunk) in RENDER_SPANS.items():
        assert rep["spans"][name]["count"] == per_chunk * CHUNKS, name
        for s in spans:
            if s.name == name:
                assert (s.parent.name if s.parent else None) == parent
    assert rep["counters"]["lane_bounces"] == CHUNKS * BOUNCES * LANES
    # the phases' self-times under the chunks add up to the chunks' time
    chunk = rep["spans"]["ptt.chunk"]["device_s"]
    selfs = sum(v["device_self_s"] for v in rep["spans"].values())
    assert selfs == pytest.approx(chunk, rel=1e-9)
    for v in rep["spans"].values():
        assert 0.0 <= v["device_self_s"] <= v["device_s"] + 1e-12
        assert v["host_s"] > 0.0


def test_live_lane_bounces_equals_the_live_lanes(scene, monkeypatch):
    live = []
    step = integrator.bounce_step

    def counted(state, *a, **k):
        live.append(int(state.alive.to(torch.int64).sum()))
        return step(state, *a, **k)

    monkeypatch.setattr(integrator, "bounce_step", counted)
    _profiled(lambda: _progressive(scene))
    rep = metrics.report()
    assert len(live) == CHUNKS * BOUNCES
    assert rep["counters"]["live_lane_bounces"] == sum(live)
    assert sum(live) < rep["counters"]["lane_bounces"]   # some lanes die


def test_radiance_keeps_its_bits_under_the_profiler(scene):
    plain = _progressive(scene)
    traced = _profiled(lambda: _progressive(scene))
    assert torch.equal(plain, traced)


@pytest.mark.parametrize("between", ["report", "unprofiled_render"])
def test_a_second_stretch_stands_alone(scene, between):
    """A stretch ends at ``report()``, or at a span opened with no profiler
    (the benchmark's untimed chunks): the next profiled one starts empty."""
    _profiled(lambda: _progressive(scene))
    first = metrics.report() if between == "report" else None
    if between == "unprofiled_render":
        _progressive(scene)
    _profiled(lambda: _progressive(scene))
    second = metrics.report()
    assert second["spans"]["ptt.chunk"]["count"] == CHUNKS
    assert second["counters"]["lane_bounces"] == CHUNKS * BOUNCES * LANES
    if first is not None:
        assert first["spans"]["ptt.chunk"]["count"] == CHUNKS
        assert metrics.report() is second   # read again: the same totals


def test_fit_step_records_its_three_parts(scene):
    cfg = RenderConfig(mode="fast", accel="none", n_samples=1, n_bounces=2)
    with torch.no_grad():
        target = render(scene, cfg, seed=0)
    params = {"mat_rgb": (scene.mat_rgb * 0.5).requires_grad_(True)}
    step = make_train_step(adam(0.05)(list(params.values())), scene, cfg,
                           target)
    _profiled(lambda: step(params, rng.split(3)[1]))
    spans = list(metrics.RECORDER.spans)
    rep = metrics.report()["spans"]
    assert rep["ptt.step"]["count"] == 1
    for part in ("ptt.forward", "ptt.backward", "ptt.optimizer"):
        assert rep[part]["count"] == 1
        (s,) = [s for s in spans if s.name == part]
        assert s.parent.name == "ptt.step"
    assert rep["ptt.rng"]["count"] == 2 * 2
    assert all(s.parent.name == "ptt.bounce" for s in spans
               if s.name == "ptt.rng")
    assert rep["ptt.step"]["device_s"] >= sum(
        rep[p]["device_s"] for p in ("ptt.forward", "ptt.backward",
                                     "ptt.optimizer"))


def test_self_time_and_thread_parents():
    """Self-time is a span's time less its children's; each thread has its
    own open spans, and a span on a thread the profiler does not follow
    records nothing and leaves the stretch open; a tensor counter is
    summed on its device and read at ``report()``."""
    seen = []

    def inner():
        seen.append(list(metrics.RECORDER.stack()))
        with metrics.span("ptt.other"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("ptt.outer"):
            with metrics.span("ptt.inner"):
                torch.ones(1000).cumsum(0)
            t = threading.Thread(target=inner)
            t.start()
            t.join(timeout=30)
            metrics.count("flags", torch.tensor([True, False, True]))
            metrics.count("flags", 2)
    assert not t.is_alive() and seen == [[]]
    assert [s.name for s in metrics.RECORDER.spans] == ["ptt.outer",
                                                        "ptt.inner"]
    assert isinstance(metrics.RECORDER.counts[0][1], torch.Tensor)
    rep = metrics.report()
    out, inn = rep["spans"]["ptt.outer"], rep["spans"]["ptt.inner"]
    assert out["device_self_s"] == pytest.approx(
        out["device_s"] - inn["device_s"])
    assert rep["counters"] == {"flags": 4}


def test_the_occluder_caches_host_read_is_a_span():
    """The cached any-hit's one host read a bounce is a ``ptt.host_read``
    span inside the bounce's ``ptt.nee``."""
    desc = synthetic.box_field_scene(n_boxes=40, width=SIDE, height=SIDE)
    field = arrays.pack_scene(desc, tri_order="morton", device="cpu")
    cfg = RenderConfig(mode="fast", accel="sparse", nee_cache="on",
                       n_samples=1, n_bounces=2)
    _profiled(lambda: render(field, cfg, seed=1))
    reads = [s for s in metrics.RECORDER.spans if s.name == "ptt.host_read"]
    assert metrics.report()["spans"]["ptt.host_read"]["count"] == 2
    assert all(s.parent.name == "ptt.nee" for s in reads)
