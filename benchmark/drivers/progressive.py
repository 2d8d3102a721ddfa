"""Progressive renders, one user in a closed loop.

Each image is the system's ``utils.checkpoint.render_progressive`` without
checkpoints: ``image_spp`` samples in chunks of ``chunk_spp`` carried as
lanes (``batch_samples``), chunk i under ``chunk_seed(image seed, i)``;
the next image starts when one is done, its seed drawn from the run's seed.
The window counts every chunk completed in it: the rate is their path
samples over the seconds from the window's start to the last one's end,
the first completion at or past the deadline closing the window. The check
traces a sample of pixels of a completed image, both drawn from the seed,
with the plain reference and compares their radiance.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import reference, scenes


class WindowClosed(Exception):
    pass


def _quiet(*_args, **_kwargs):
    return None


class Run:
    def __init__(self, wl: dict, config: dict, traffic: dict, seed: int,
                 device: str = "cuda"):
        self.name = wl["name"]
        self.config = config
        self.p = {**config["render"], **traffic.get("render", {})}
        self.traffic = traffic
        self.device = device
        self.seed = seed % 2**64
        self._seeds = np.random.default_rng([self.seed, 0])
        self._pick = np.random.default_rng([self.seed, 1])
        self.images = []
        self.sample = None

    def _next_seed(self) -> int:
        return int(self._seeds.integers(0, 2**31 - 1))

    def _sync(self):
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()

    def setup(self):
        from pathtracerpython_tpu_torch.render.config import RenderConfig
        from pathtracerpython_tpu_torch.utils.checkpoint import (
            render_progressive,
        )

        self._render_progressive = render_progressive
        p = self.p
        self.raw = scenes.build(self.config["scene"])
        self.scene = scenes.program_scene(self.raw, self.config["scene"],
                                          self.device)
        self.cfg = RenderConfig(mode=p["mode"], accel=p["accel"],
                                n_samples=p["image_spp"],
                                n_bounces=p["n_bounces"],
                                n_light_samples=p["n_light_samples"],
                                batch_samples=True)
        # the one shape the window runs: a chunk of chunk_spp lanes a pixel
        self._image(self._next_seed(), p["chunk_spp"])
        self._sync()

    def _image(self, seed: int, total: int, progress=None):
        return self._render_progressive(
            self.scene, self.cfg, total, self.p["chunk_spp"], None,
            seed=seed, log=_quiet, progress=progress)

    @property
    def paths_per_chunk(self) -> int:
        return self.raw.width * self.raw.height * self.p["chunk_spp"]

    def window(self, seconds: float) -> tuple[dict, int, int, str]:
        """(metrics, attempted, failed, an info line)."""
        done = []
        t0 = time.perf_counter()
        deadline = t0 + seconds

        def progress(chunk_done, n_chunks, *_):
            done.append(time.perf_counter())
            if done[-1] >= deadline and chunk_done < n_chunks:
                raise WindowClosed

        while not done or done[-1] < deadline:
            seed = self._next_seed()
            try:
                img = self._image(seed, self.p["image_spp"], progress)
            except WindowClosed:
                break
            self.images.append((seed, img))
        elapsed = done[-1] - t0
        paths = len(done) * self.paths_per_chunk
        b, s = self.p["n_bounces"], self.p["n_light_samples"]
        info = (f"{self.name}: {len(done)} chunks, {len(self.images)} images"
                f" in {elapsed!r} s; Mrays/s all rays (paths x bounces x "
                f"(1 + NEE)) {paths * b * (1 + s) / elapsed / 1e6!r}, path "
                f"segments (paths x bounces) {paths * b / elapsed / 1e6!r}")
        return ({"paths_per_s": paths / elapsed / 1e6}, len(done), 0, info)

    def traced(self) -> dict:
        """The summary of ``trace_units`` chunks of a fresh image under the
        profiler, with the work of one chunk."""
        from benchmark import trace

        units = self.traffic["trace_units"]
        seed = self._next_seed()
        events, window_s = trace.profile(
            lambda: self._image(seed, units * self.p["chunk_spp"]),
            self._sync)
        return {"events": events, "window_s": window_s, "units": units,
                "work": {"lanes": self.paths_per_chunk,
                         "bounces": self.p["n_bounces"],
                         "light_samples": self.p["n_light_samples"],
                         "triangles": self.raw.n_triangles}}

    def release(self):
        """Keep the checked pixels of one completed image, drawn from the
        seed, on the host; free the rest of the system's state."""
        import torch

        if self.images:
            i, pixels = self._choose(len(self.images))
            seed, img = self.images[i]
            rows = torch.as_tensor(pixels, device=img.device)
            self.sample = (seed, pixels, img[rows].float().cpu())
        self.images = []
        self.scene = None

    def _choose(self, n_images: int):
        """(the checked image, its checked pixels), drawn from the seed."""
        i = int(self._pick.integers(n_images))
        n_pix = self.raw.width * self.raw.height
        return i, np.sort(self._pick.choice(n_pix, size=min(
            self.config["check"]["pixels"], n_pix), replace=False))

    def reference_pixels(self, seed: int, pixels, dtype, device):
        import torch

        p = self.p
        ref = reference.build_scene(self.raw, device, dtype)
        return reference.render_pixels(
            ref, seed, torch.as_tensor(pixels, device=device),
            p["image_spp"], p["chunk_spp"], p["n_bounces"],
            p["n_light_samples"], mode=p["mode"]).cpu()

    def check(self, limits: dict, device: str) -> list[tuple]:
        """[(name, value, limit)]: the relative L1 gap of the sampled
        pixels' radiance against the float32 reference."""
        import torch

        lim = limits["radiance_rel_l1"]
        if self.sample is None:
            return [("radiance_rel_l1", float("inf"), lim)]
        seed, pixels, got = self.sample
        want = self.reference_pixels(seed, pixels, torch.float32, device)
        return [("radiance_rel_l1", rel_l1(got, want), lim)]


def rel_l1(got, want) -> float:
    """sum |got - want| / sum |want| over pixels and channels."""
    return float((got.double() - want.double()).abs().sum()
                 / want.double().abs().sum())


def readings(wl: dict, config: dict, traffic: dict, seeds: list, kind: str,
             device: str) -> list[dict]:
    """The check's number on each seed, at the cell's own size: of the
    program's first image (``program``), or of the reference in bfloat16
    put in the program's place (``control``)."""
    import torch

    out = []
    base = None
    for seed in seeds:
        run = Run(wl, config, traffic, seed, device)
        if kind == "control":
            run.raw = scenes.build(config["scene"])
            s = run._next_seed()
            _, pixels = run._choose(1)
            got = run.reference_pixels(s, pixels, torch.bfloat16, device)
            want = run.reference_pixels(s, pixels, torch.float32, device)
            value = rel_l1(got, want)
        else:
            if base is None:
                run.setup()
                base = run
            else:
                for k in ("raw", "scene", "cfg", "_render_progressive"):
                    setattr(run, k, getattr(base, k))
            s = run._next_seed()
            run.images = [(s, run._image(s, run.p["image_spp"]))]
            scene = run.scene
            run.release()
            run.scene = scene
            value = run.check({"radiance_rel_l1": float("inf")}, device)[0][1]
        out.append({"seed": seed, "radiance_rel_l1": value})
    return out
