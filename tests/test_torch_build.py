"""The port's packaging rules, checked on the CPU: it never imports jax,
its top-level package imports nothing heavy, the CUDA build uses the flags
that keep the kernels' rounding equal to their plain versions, a failed
build raises, and a CPU render never touches the build."""

import ctypes
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from pathtracerpython_tpu_torch.kernels import (
    build,
    intersect,
    nee,
    sparse,
    walker,
)
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene import arrays, synthetic

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Run in a fresh interpreter: tests/conftest.py has already imported jax
# into this one.
_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import pathtracerpython_tpu_torch as pkg
top_level = sorted(m for m in ("torch", "numpy", "jax") if m in sys.modules)
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from pathtracerpython_tpu_torch.kernels import build
print(json.dumps({
    "top_level": top_level,
    "modules": names,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "library_loaded": build._lib is not None,
}))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_port_never_imports_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax"] == []
    # the package __init__ alone pulls in no framework
    assert out["top_level"] == []
    for name in ("scene.arrays", "ops.rng", "ops.sort", "kernels.intersect",
                 "kernels.nee", "kernels.sparse", "kernels.walker",
                 "kernels.build", "render.integrator", "probes.mma_probe",
                 "probes.bf16_probe", "parallel", "parallel.mesh",
                 "parallel.multihost", "parallel.shard", "parallel.ring",
                 "parallel.pipeline", "entry", "diff.inverse", "cli.main"):
        assert f"pathtracerpython_tpu_torch.{name}" in out["modules"], name
    # importing every module builds and loads nothing
    assert out["library_loaded"] is False


def test_nvcc_flags_keep_plain_rounding():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags


def test_sources_are_in_the_package():
    names = sorted(os.path.basename(p) for p in build._sources())
    assert names == ["aabb.cuh", "any_hit.cu", "any_hit_walk.cuh",
                     "cluster.cuh", "mt.cuh", "nearest.cu",
                     "nee.cu", "plucker.cuh", "probe_bf16.cu",
                     "probe_plucker.cu", "scatter_rows.cu",
                     "sparse_any_hit.cu", "sparse_any_hit_idx.cu",
                     "sparse_nearest.cu", "threefry.cu", "two_pass.cu",
                     "walker_any_hit.cu", "walker_nearest.cu"]


def _c_parameters(source: str, entry: str) -> list[str]:
    """The parameter declarations of ``extern "C" int entry(...)`` in
    ``csrc/source``."""
    with open(os.path.join(build.CSRC_DIR, source)) as f:
        text = f.read()
    head = text.index(f'extern "C" int {entry}(')
    body = text[text.index("(", head) + 1:text.index(")", head)]
    return [" ".join(p.split()) for p in body.split(",")]


@pytest.mark.parametrize("source,entry,argtypes", [
    ("nearest.cu", "ptt_nearest_t_idx", intersect._ARGTYPES),
    ("nearest.cu", "ptt_plucker_nearest_t_idx", intersect._ARGTYPES),
    ("any_hit.cu", "ptt_any_hit", intersect._ANY_HIT_ARGTYPES),
    ("any_hit.cu", "ptt_plucker_any_hit", intersect._ANY_HIT_ARGTYPES),
    ("sparse_nearest.cu", "ptt_sparse_nearest", sparse._ARGTYPES),
    ("sparse_nearest.cu", "ptt_plucker_sparse_nearest", sparse._ARGTYPES),
    ("walker_nearest.cu", "ptt_walker_nearest", walker._NEAREST_ARGTYPES),
    ("sparse_any_hit.cu", "ptt_sparse_any_hit", sparse._ANY_HIT_ARGTYPES),
    ("sparse_any_hit.cu", "ptt_plucker_sparse_any_hit",
     sparse._ANY_HIT_ARGTYPES),
    ("walker_any_hit.cu", "ptt_walker_any_hit", sparse._ANY_HIT_ARGTYPES),
    ("sparse_any_hit_idx.cu", "ptt_sparse_any_hit_idx",
     sparse._ANY_HIT_IDX_ARGTYPES),
])
def test_entry_signatures_match_their_argtypes(source, entry, argtypes):
    """ctypes passes what ``argtypes`` says, whatever the C entry declares:
    a pointer where the entry takes an int (or the reverse) would be cut or
    misread without an error. The dense sweeps' entries take their cull
    boxes and counters: o3, d3, (maxd,) n, pack, t_count, tile boxes, group
    boxes, outputs, stats, device, stream; the split nearest walks (K5 in
    both forms, K8) their scratch words before the outputs, and their
    counters; the split any-hit walks (K6 in both forms, K9, K7) their
    cluster boxes after the clusters' AABBs, and their counters after the
    marks (K7: after its scratch of first slots and its two outputs)."""
    params = _c_parameters(source, entry)
    assert len(params) == len(argtypes), params
    for decl, argtype in zip(params, argtypes):
        want = ctypes.c_void_p if "*" in decl else ctypes.c_int
        assert argtype is want, (decl, argtype)
    names = [decl.split("*")[-1].split()[-1] for decl in params]
    if "t_count" in names:
        assert names[names.index("t_count") + 1:][:2] == ["tile_boxes",
                                                          "group_boxes"]
    elif "occ" in names:
        assert names[names.index("aabb8") + 1] == "cull"
        assert names[names.index("occ") + 1] == "stats"
    elif "first_slot" in names:
        assert names[names.index("aabb8") + 1] == "cull"
        assert names[names.index("first_slot") + 1:][:3] == [
            "occ_out", "cl_out", "stats"]
    else:
        assert names[names.index("words") + 1:][:2] == ["t_out", "idx_out"]
    assert names[-3:] == ["stats", "device", "stream"]


def test_threefry_entry_signature_matches_its_argtypes():
    """ops/rng.py's argtypes for csrc/threefry.cu's entry, type by type: a
    64-bit count or stride passed as an int, or a key word as a signed int
    past 2^31, would be cut or refused by ctypes."""
    from pathtracerpython_tpu_torch.ops import rng

    kinds = {"long long": ctypes.c_longlong, "int": ctypes.c_int,
             "unsigned": ctypes.c_uint}
    params = _c_parameters("threefry.cu", "ptt_threefry_uniforms")
    assert len(params) == len(rng._ARGTYPES), params
    for decl, argtype in zip(params, rng._ARGTYPES):
        kind = decl.rsplit(" ", 1)[0].replace("const ", "")
        want = ctypes.c_void_p if "*" in decl else kinds[kind]
        assert argtype is want, (decl, argtype)
    names = [decl.split("*")[-1].split()[-1] for decl in params]
    assert names == ["counters", "stride", "counter_bytes", "n", "n_draws",
                     "k0", "k1", "out", "device", "stream"]


def test_walk_segment_is_the_kernels_constant():
    """``sparse.WALK_SEGMENT`` mirrors ``kSegment`` of csrc/cluster.cuh,
    which the split nearest walks are compiled with, and
    ``sparse.ANY_HIT_SEGMENT`` ``kAnyHitSegment`` of csrc/any_hit_walk.cuh,
    which the split any-hit walks are."""
    for source, name, value in (
            ("cluster.cuh", "kSegment", sparse.WALK_SEGMENT),
            ("any_hit_walk.cuh", "kAnyHitSegment", sparse.ANY_HIT_SEGMENT)):
        with open(os.path.join(build.CSRC_DIR, source)) as f:
            text = f.read()
        decl = text[text.index(f"constexpr int {name} = "):].split(";")[0]
        assert int(decl.split("=")[1]) == value, name


def test_cluster_box_levels_are_the_kernels():
    """The rows under a span, mid and group box of ``cluster_cull_boxes``
    are csrc/aabb.cuh's, which csrc/any_hit_walk.cuh culls a cluster by,
    and the table has its boxes in that header's order and number."""
    with open(os.path.join(build.CSRC_DIR, "aabb.cuh")) as f:
        text = f.read()
    for name, rows in (("kSpanRows", sparse.SPAN_ROWS),
                       ("kMidRows", sparse.MID_ROWS),
                       ("kGroup", intersect.CULL_GROUP)):
        decl = text[text.index(f"constexpr int {name} = "):].split(";")[0]
        assert int(decl.split("=")[1]) == rows, name
    assert sparse.CLUSTER_BOXES == 4 + 16 + 64


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    before = build.library_path()
    assert build.library_path() == before
    with open(csrc / "nee.cu", "a") as f:
        f.write("\n// edited\n")
    assert build.library_path() != before


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails leaves no library and raises; nothing falls
    back to the plain versions."""
    failing = shutil.which("false")
    assert failing is not None
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "torch_kernels"))
    monkeypatch.setattr(build, "find_nvcc", lambda: failing)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_functions", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.function("ptt_nearest_t_idx", [])
    assert not os.path.exists(build.library_path())
    assert build._lib is None


def test_cpu_render_runs_the_plain_versions(monkeypatch):
    """On CPU tensors the wrappers take their plain versions: the CUDA
    library is never built, loaded or counted."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path asked for the CUDA library")

    monkeypatch.setattr(build, "function", refuse)
    counters = [(intersect, "LAUNCHES"), (intersect, "ANY_HIT_LAUNCHES"),
                (nee, "LAUNCHES"), (sparse, "LAUNCHES"), (walker, "LAUNCHES"),
                (intersect, "PLUCKER_LAUNCHES"),
                (intersect, "PLUCKER_ANY_HIT_LAUNCHES"),
                (sparse, "PLUCKER_LAUNCHES"),
                (sparse, "PLUCKER_ANY_HIT_LAUNCHES")]
    for module, name in counters:
        monkeypatch.setattr(module, name, 0)
    scene = arrays.pack_scene(synthetic.cornell_box_scene(6, 6), pad_to=32,
                              device="cpu")
    for accel, mt_impl in (("none", None), ("hybrid", None),
                           ("none", "plucker"), ("sparse", "plucker")):
        rad = render(scene, RenderConfig(n_samples=1, n_bounces=2,
                                         accel=accel, mt_impl=mt_impl),
                     seed=0)
        assert rad.device == torch.device("cpu") and rad.shape == (36, 3)
    assert all(getattr(module, name) == 0 for module, name in counters)


_RACE = """
import sys
from pathtracerpython_tpu_torch.kernels import build
build.BUILD_DIR, fake = sys.argv[1], sys.argv[2]
build.find_nvcc = lambda: fake
print(build.build())
"""


def test_processes_started_together_build_once(tmp_path):
    """Ranks started together on a fresh checkout compile the library once:
    the others wait on the build's file lock and load it. A fake nvcc logs
    each call, sleeps, and writes its ``-o`` file."""
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo \"$$\" >> {log}\n"
        "sleep 0.3\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then : > \"$2\"; fi\n"
        "  shift\n"
        "done\n")
    fake.chmod(0o755)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RACE, str(tmp_path / "torch_kernels"),
         str(fake)], env=env, cwd=REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1 and os.path.exists(paths.pop())
    n_sources = sum(p.endswith(".cu") for p in build._sources())
    # one compile per source and one link, by one process
    assert len(log.read_text().split()) == n_sources + 1
