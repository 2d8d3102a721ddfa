"""The port's CLI (``python -m pathtracerpython_tpu_torch``, ``cli/main.py``)
on the CPU: its flags against the JAX CLI's, the PNG it writes against
``render_image``, its image against the JAX CLI's on one SDL file written
by ``synthetic.write_sdl``, its refusals (no CUDA without ``--platform
cpu``, ``--dp`` / ``--geom`` above 1 outside torchrun), sharded renders
under torchrun on gloo ranks (their PNG the one-process CLI's), chunked
progress, ``--quiet``, ``--metrics``, ``--ckpt-dir`` resume and the debug
view.

Tolerances: the port's PNG is ``render_image``'s pixels exactly; against
the JAX CLI (``--backend pallas``: its kernels in interpret mode in fast
mode, its XLA sweeps in reference mode) the decoded pixels are equal on
99% of them (radiance differs in the last bits, and the min-max
normalization can move a pixel across a rounding step)."""

import argparse
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from pathtracerpython_tpu.scene.arrays import load_scene as jax_load_scene
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render_image
from pathtracerpython_tpu_torch.scene import synthetic
from pathtracerpython_tpu_torch.scene.arrays import load_scene, pack_scene
from pathtracerpython_tpu_torch.utils import CheckpointManager
from torch_parity import jax_leaves, port_leaves

# the modules (each package's cli/__init__.py exports the function main)
cli = importlib.import_module("pathtracerpython_tpu_torch.cli.main")
jax_cli = importlib.import_module("pathtracerpython_tpu.cli.main")
SIZE = 12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the time of a test alone and
    leaves the other test workers their cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def sdl(tmp_path_factory):
    desc = dataclasses.replace(synthetic.cornell_box_scene(SIZE, SIZE),
                               npaths=3, seed=4, tonemapping=2.0)
    return synthetic.write_sdl(desc, str(tmp_path_factory.mktemp("scene")))


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path))


def _parser(setup, monkeypatch) -> argparse.ArgumentParser:
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        lambda self, argv=None: self)
    return setup([])


def test_parsers_take_the_same_flags(monkeypatch):
    port, jax = (_parser(s, monkeypatch) for s in (cli.setup,
                                                   jax_cli.setup))

    def flags(p):
        return {tuple(a.option_strings) or a.dest: a for a in p._actions}

    got, want = flags(port), flags(jax)
    assert set(got) == set(want)
    for name, action in want.items():
        if name == ("--platform",):  # the port's platforms: cpu, cuda
            assert got[name].choices == ("default", "cpu", "cuda")
            continue
        assert got[name].default == action.default, name
        assert got[name].choices == action.choices, name
        assert got[name].type == action.type, name
    monkeypatch.undo()
    args = cli.setup(["s.sdl", "--out", "x.png", "-r", "4", "-b", "3",
                      "--show-img", "--show-scene", "--show-normals",
                      "--show-screen", "--show-inter"])
    assert (args.scene, args.rays_per_pixel, args.bounces) == ("s.sdl", 4, 3)
    assert args.show_img and args.show_inter


def test_write_sdl_round_trips_through_both_loaders(sdl):
    got = port_leaves(load_scene(sdl, device="cpu"))
    want = jax_leaves(jax_load_scene(sdl))
    packed = port_leaves(pack_scene(synthetic.cornell_box_scene(SIZE, SIZE),
                                    device="cpu"))
    for f, v in want.items():
        np.testing.assert_array_equal(got[f], v)
        np.testing.assert_array_equal(packed[f], v)


@pytest.mark.parametrize("mode", ["fast", "reference"])
def test_png_is_render_image(sdl, tmp_path, mode):
    out = str(tmp_path / "o.png")
    rc = cli.main([sdl, "--out", out, "-r", "2", "-b", "2", "--mode", mode,
                   "--seed", "5", "--platform", "cpu", "--quiet"])
    assert rc == 0
    scene = load_scene(sdl, device="cpu")
    want = render_image(scene, RenderConfig(mode=mode, n_samples=2,
                                            n_bounces=2), seed=5)
    np.testing.assert_array_equal(_png(out), want)


@pytest.mark.parametrize("mode", ["fast", "reference"])
def test_port_cli_matches_jax_cli(sdl, tmp_path, mode):
    common = [sdl, "-r", "2", "-b", "2", "--mode", mode, "--platform", "cpu",
              "--backend", "pallas", "--accel", "none", "--quiet"]
    assert cli.main(common + ["--out", str(tmp_path / "port.png")]) == 0
    assert jax_cli.main(common + ["--out", str(tmp_path / "jax.png")]) == 0
    got, want = _png(tmp_path / "port.png"), _png(tmp_path / "jax.png")
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    equal = (got == want).all(axis=-1)
    assert equal.mean() >= 0.99, equal.mean()
    assert got.max() == 255


def test_no_cuda_without_platform_cpu_exits_nonzero(sdl, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default renders there")
    out = tmp_path / "o.png"
    assert cli.main([sdl, "--out", str(out)]) == cli.EXIT_REFUSED
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()
    # the module entry point, as a user runs it: exit status, and with
    # --platform cpu a PNG
    run = [sys.executable, "-m", "pathtracerpython_tpu_torch", sdl, "--out",
           str(out), "--mode", "reference", "-r", "4", "-b", "2", "--quiet"]
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(run, capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode != 0 and "--platform cpu" in proc.stderr
    assert not out.exists()
    proc = subprocess.run(run + ["--platform", "cpu"], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert _png(out).shape == (SIZE, SIZE, 3)


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--geom", "2"],
                                   ["--dp", "2", "--geom", "2"]])
def test_sharding_refuses_naming_a4(sdl, tmp_path, capsys, flags,
                                    monkeypatch):
    """Outside torchrun a mesh of more than one rank refuses (exit 2) and
    prints the launch line (A4 brought the sharded CLI; the old refusal
    named it)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    out = tmp_path / "o.png"
    rc = cli.main([sdl, "--out", str(out), "--platform", "cpu", *flags])
    assert rc == cli.EXIT_REFUSED
    ranks = 4 if len(flags) == 4 else 2
    err = capsys.readouterr().err
    assert (f"python -m torch.distributed.run --standalone --nproc-per-node "
            f"{ranks} -m pathtracerpython_tpu_torch {sdl}") in err
    assert not out.exists()


def test_dp_one_renders_in_one_process(sdl, tmp_path):
    """``--dp 1``: the mesh of one rank, the single render's image."""
    out = tmp_path / "o.png"
    assert cli.main([sdl, "--out", str(out), "--platform", "cpu", "-r", "2",
                     "-b", "2", "--dp", "1", "--quiet"]) == 0
    scene = load_scene(sdl, device="cpu")
    want = render_image(scene, RenderConfig(n_samples=2, n_bounces=2))
    np.testing.assert_array_equal(_png(out), want)


def _cli_run(args, n_ranks: int, tmp_path):
    """The CLI as a user runs it, on ``n_ranks`` under torchrun (its
    standalone rendezvous picks a free port)."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc-per-node", str(n_ranks), "-m"]
    return subprocess.run(launch + ["pathtracerpython_tpu_torch", *args],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)


@pytest.mark.parametrize("mesh,extra", [
    (["--dp", "2"], []), (["--geom", "2"], []),
    (["--dp", "2"], ["--chunk-spp", "2", "--ckpt-dir", "CKPT"])])
def test_sharded_cli_under_torchrun_matches_one_process(sdl, tmp_path, mesh,
                                                        extra):
    """Two gloo ranks: rank 0 alone logs, writes the PNG (the one-process
    CLI's pixels) and the checkpoints."""
    def flags(run: str):
        return [sdl, "-r", "4", "-b", "2", "--platform", "cpu", "--out",
                str(tmp_path / f"{run}.png"),
                *(str(tmp_path / f"ckpt_{run}") if f == "CKPT" else f
                  for f in extra)]

    assert cli.main(flags("one") + ["--quiet"]) == 0
    two = _cli_run(flags("two") + mesh, 2, tmp_path)
    assert two.returncode == 0, two.stderr
    np.testing.assert_array_equal(_png(tmp_path / "two.png"),
                                  _png(tmp_path / "one.png"))
    assert two.stdout.count("wrote ") == 1
    assert "backend gloo" in two.stdout and "mesh: " in two.stdout
    if extra:
        steps = sorted(os.listdir(tmp_path / "ckpt_two"))
        assert steps == ["step_00000001", "step_00000002"], steps


def test_chunked_progress_lines_and_quiet(sdl, tmp_path, capsys):
    out = str(tmp_path / "o.png")
    args = [sdl, "--out", out, "-r", "8", "-b", "1", "--chunk-spp", "4",
            "--platform", "cpu"]
    assert cli.main(args) == 0
    lines = capsys.readouterr().out.splitlines()
    prog = [ln for ln in lines if ln.startswith("chunk ")]
    assert len(prog) == 2, lines
    assert "1/2" in prog[0] and "2/2" in prog[1] and "Mrays/s" in prog[0]
    assert "chunks: 4 spp each" in lines
    assert cli.main(args + ["--quiet"]) == 0
    assert capsys.readouterr().out == ""


def test_auto_chunk_at_64_spp_is_logged(sdl, tmp_path, capsys):
    out = str(tmp_path / "o.png")
    assert cli.main([sdl, "--out", out, "-r", "64", "-b", "1",
                     "--light-samples", "1", "--platform", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any("auto-chunked at 16 spp" in ln for ln in lines)
    assert len([ln for ln in lines if ln.startswith("chunk ")]) == 4
    help_text = subprocess.run(
        [sys.executable, "-m", "pathtracerpython_tpu_torch", "--help"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO}).stdout
    assert "auto-chunks at 16 spp" in help_text
    assert "sample->RNG mapping" in help_text


def test_metrics_json_and_honor_sdl(sdl, tmp_path, capsys):
    """--metrics prints one JSON line; --honor-sdl takes the SDL's npaths
    (3) and seed (4), and explicit flags win."""
    out = str(tmp_path / "o.png")
    assert cli.main([sdl, "--out", out, "-b", "1", "--honor-sdl",
                     "--metrics", "--platform", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any("n_samples=3" in ln for ln in lines)
    metrics = json.loads([ln for ln in lines if ln.startswith("{")][-1])
    assert metrics["counters"]["rays_attempted"] == SIZE * SIZE * 3 * 4
    assert metrics["calls"] == {"render": 1, "render_steady": 1}
    assert metrics["device"] == "cpu"
    assert metrics["rays_attempted_per_s_steady"] > 0
    assert cli.main([sdl, "--out", out, "-b", "1", "-r", "2", "--honor-sdl",
                     "--platform", "cpu"]) == 0
    assert "n_samples=2" in capsys.readouterr().out


def test_ignored_flags_are_noted(sdl, tmp_path, capsys):
    out = str(tmp_path / "o.png")
    assert cli.main([sdl, "--out", out, "--backend", "xla",
                     "--no-compile-cache", "--mt-impl", "plucker",
                     "--platform", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "--backend xla is ignored" in text
    assert "--no-compile-cache is ignored" in text
    assert "mt_impl='plucker'" in text


def test_ckpt_dir_resume_bit_matches(sdl, tmp_path, capsys):
    """A run stopped after chunk 2 of 4 and resumed gives the uninterrupted
    run's accumulation bit for bit, and its PNG."""
    def run(ckpt: str, spp: int, out: str):
        assert cli.main([sdl, "--out", str(tmp_path / out), "-r", str(spp),
                         "-b", "2", "--chunk-spp", "2", "--ckpt-dir",
                         str(tmp_path / ckpt), "--platform", "cpu"]) == 0
        return capsys.readouterr().out

    run("full", 8, "full.png")
    run("part", 4, "first.png")
    assert "resumed at chunk 2/4" in run("part", 8, "resumed.png")
    full, part = (CheckpointManager(str(tmp_path / d)).restore(4)
                  for d in ("full", "part"))
    assert torch.equal(full["radiance_sum"], part["radiance_sum"])
    assert full["samples_done"] == part["samples_done"] == 8
    np.testing.assert_array_equal(_png(tmp_path / "full.png"),
                                  _png(tmp_path / "resumed.png"))


def test_debug_view_written(sdl, tmp_path):
    out = str(tmp_path / "o.png")
    assert cli.main([sdl, "--out", out, "--platform", "cpu", "--quiet",
                     "--show-scene", "--show-inter", "--show-normals",
                     "--show-screen", "--mode", "reference"]) == 0
    assert _png(tmp_path / "o_scene.png").ndim == 3


def _png_with_filters(img: np.ndarray, kinds) -> bytes:
    """A PNG of ``img`` [H, W, 3] whose row y uses filter kinds[y % len]
    (0 none, 1 sub, 2 up, 3 average, 4 Paeth), encoded here by hand."""
    import struct
    import zlib

    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if kind == 4:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        else:
            pred = [0 * cur, left, up, (left + up) // 2][kind]
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


def test_png_writer_and_reader(tmp_path):
    """``save_png`` decodes in PIL to the pixels PIL writes (grey, RGB and
    RGBA), and ``read_png`` reads PIL's PNGs and every filter type."""
    from pathtracerpython_tpu_torch.render.image import read_png, save_png

    rng = np.random.default_rng(0)
    for shape in [(9, 7, 3), (5, 11), (4, 6, 4), (1, 1, 3)]:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        save_png(img, str(tmp_path / "port.png"))
        Image.fromarray(img).save(str(tmp_path / "pil.png"))
        for path in ("port.png", "pil.png"):
            np.testing.assert_array_equal(_png(tmp_path / path), img)
            np.testing.assert_array_equal(read_png(str(tmp_path / path)),
                                          img)
    y, x = np.mgrid[0:12, 0:10]
    img = np.stack([x * 20, y * 17, (x * y) % 256], -1).astype(np.uint8)
    (tmp_path / "f.png").write_bytes(_png_with_filters(img, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(_png(tmp_path / "f.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "f.png")), img)
    with pytest.raises(ValueError, match="uint8"):
        save_png(img.astype(np.float32), str(tmp_path / "bad.png"))
