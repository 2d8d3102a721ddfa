"""Inverse rendering: training steps back to back.

Set-up renders the target with the system from the true scene, starts the
parameters from the truth with ``start_scale`` times its ``mat_rgb``, builds
one ``diff.inverse.make_train_step`` over ``diff.inverse.adam(lr)``, and
drives that same step through the first ``checked_steps`` steps, each
under the next key of the key walk ``fit()`` takes (key, sub = split(key)),
keeping their losses, the first gradient as Adam's first moment holds it,
and the parameters after them. The window goes on with the same objects:
steps back to back, the loss kept on the device, a CUDA event at every
step boundary, read once the window has closed. The check runs the plain
reference's fit from the same start over the same keys.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import harness, reference, scenes

BETA1 = 0.9


class Run:
    def __init__(self, wl: dict, config: dict, traffic: dict, seed: int,
                 device: str = "cuda"):
        self.name = wl["name"]
        self.config = config
        self.p = {**config["render"], **traffic.get("render", {})}
        self.traffic = traffic
        self.device = device
        rs = np.random.default_rng([seed % 2**64, 2])
        self.target_seed = int(rs.integers(0, 2**31 - 1))
        self.key_seed = int(rs.integers(0, 2**31 - 1))
        self.first = None

    def _sync(self):
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()

    def setup(self):
        import torch
        from pathtracerpython_tpu_torch.diff.inverse import (
            adam,
            make_train_step,
        )
        from pathtracerpython_tpu_torch.ops import rng
        from pathtracerpython_tpu_torch.render.config import RenderConfig
        from pathtracerpython_tpu_torch.render.integrator import render

        self._split = rng.split
        p, t = self.p, self.traffic
        self.raw = scenes.build(self.config["scene"])
        scene = scenes.program_scene(self.raw, self.config["scene"],
                                     self.device)
        cfg = RenderConfig(mode="fast", accel=p["accel"],
                           n_samples=p["step_spp"],
                           n_bounces=p["n_bounces"],
                           n_light_samples=p["n_light_samples"],
                           batch_samples=True)
        with torch.no_grad():
            target = render(scene, cfg, seed=self.target_seed)
        start = {f: getattr(scene, f).detach().clone() for f in t["params"]}
        start["mat_rgb"] = start["mat_rgb"] * t["start_scale"]
        self.p0 = {k: v.clone() for k, v in start.items()}
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in start.items()}
        self.opt = adam(t["lr"])(list(self.params.values()))
        self.step = make_train_step(self.opt, scene, cfg, target)
        self.key = rng.key_from_seed(self.key_seed)
        losses = []
        for i in range(t["checked_steps"]):
            losses.append(self._one())
            if i == 0:
                self.grad1 = {k: self._first_moment(v) / (1.0 - BETA1)
                              for k, v in self.params.items()}
        self.first = {
            "losses": losses,
            "params": {k: v.detach().clone() for k, v in self.params.items()},
        }
        self._sync()

    def _first_moment(self, leaf):
        """Adam's first moment of ``leaf``: (1 - beta1) times the first
        gradient after one step; zeros where the step kept no state."""
        state = self.opt.state.get(leaf, {})
        if "exp_avg" not in state:
            return leaf.detach().new_zeros(leaf.shape)
        return state["exp_avg"].detach().clone()

    def _one(self):
        self.key, sub = self._split(self.key)
        return self.step(self.params, sub)

    def window(self, seconds: float) -> tuple[dict, int, int, str]:
        import torch

        cuda = self.device != "cpu"
        marks = []

        def mark():
            if cuda:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append(e)
            else:
                marks.append(time.perf_counter())

        losses = []
        self._sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        mark()
        while True:
            losses.append(self._one())
            mark()
            if time.perf_counter() >= deadline:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        if cuda:
            steps_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            steps_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        n = len(losses)
        info = (f"{self.name}: {n} steps in {elapsed!r} s; step ms by "
                f"events: median {harness.percentile(steps_ms, 50)!r}, max "
                f"{max(steps_ms)!r}; last loss {float(losses[-1])!r}")
        return ({"step_ms": elapsed / n * 1e3,
                 "step_p95_ms": harness.percentile(steps_ms, 95)}, n, bad,
                info)

    def traced(self) -> dict:
        from benchmark import trace

        units = self.traffic["trace_units"]

        def steps():
            for _ in range(units):
                self._one()

        events, window_s = trace.profile(steps, self._sync)
        p = self.p
        return {"events": events, "window_s": window_s, "units": units,
                "work": {"lanes": self.raw.width * self.raw.height
                         * p["step_spp"], "bounces": p["n_bounces"],
                         "light_samples": p["n_light_samples"],
                         "triangles": self.raw.n_triangles}}

    def release(self):
        """Keep the first steps' readings on the host; free the rest."""
        self.first = {
            "losses": [float(x) for x in self.first["losses"]],
            "grad1": {k: v.cpu() for k, v in self.grad1.items()},
            "p0": {k: v.cpu() for k, v in self.p0.items()},
            "params": {k: v.cpu() for k, v in self.first["params"].items()},
        }
        self.step = self.opt = self.params = self.grad1 = None

    def reference_fit(self, dtype, device):
        """(losses, first gradients, params after the checked steps) of
        the plain reference from the same start, over the same keys."""
        import torch

        t, p = self.traffic, self.p
        truth = reference.build_scene(self.raw, device, dtype)
        with torch.no_grad():
            target = reference.image_all(
                truth, reference.key_of(self.target_seed), p["step_spp"],
                p["n_bounces"], p["n_light_samples"])
        start = reference.scene_params(truth)
        start = {k: start[k].detach().clone() for k in t["params"]}
        start["mat_rgb"] = start["mat_rgb"] * t["start_scale"]
        key, keys = reference.key_of(self.key_seed), []
        for _ in range(t["checked_steps"]):
            key, sub = reference.split(key)
            keys.append(sub)
        losses, grads, params = reference.fit_steps(
            truth, target, start, keys, p["step_spp"], p["n_bounces"],
            p["n_light_samples"], t["lr"])
        return (losses, {k: v.cpu() for k, v in grads.items()},
                {k: v.cpu() for k, v in params.items()},
                {k: v.cpu() for k, v in start.items()})

    def check(self, limits: dict, device: str) -> list[tuple]:
        import torch

        ref = self.reference_fit(torch.float32, device)
        return compare(self.first, ref, limits)


def _norm(x) -> float:
    return float(x.double().norm())


def compare(first: dict, ref: tuple, limits: dict) -> list[tuple]:
    """[(name, value, limit)] of the program's first steps against the
    reference's: the first step's relative loss gap (the later steps'
    losses follow Adam's first update, which moves a parameter whose
    gradient is round-off by the full rate either way); of the first
    gradient and of the parameters' change, the worst leaf's gap between
    the two norms, over the larger of the reference leaf's norm and the
    median leaf's. The change leaves out leaves whose reference gradient
    is under a thousandth of the median leaf's."""
    r_losses, r_grad, r_params, r_start = ref
    loss_gap = abs(first["losses"][0] - r_losses[0]) / abs(r_losses[0])
    g_ref = {k: _norm(v) for k, v in r_grad.items()}
    g_med = float(np.median(list(g_ref.values())))
    grad_gap = max(abs(_norm(first["grad1"][k]) - g_ref[k])
                   / max(g_ref[k], g_med) for k in g_ref)
    keep = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_ref = {k: _norm(r_params[k] - r_start[k]) for k in keep}
    d_med = float(np.median(list(d_ref.values())))
    change_gap = max(abs(_norm(first["params"][k] - first["p0"][k])
                         - d_ref[k]) / max(d_ref[k], d_med) for k in keep)
    return [("loss1_gap", loss_gap, limits["loss1_gap"]),
            ("grad_gap", grad_gap, limits["grad_gap"]),
            ("change_gap", change_gap, limits["change_gap"])]


def _half_batch_loss(params, base_scene, target, render_fn, pixel_ids, key):
    """A planted fault: the loss over every other pixel only."""
    from pathtracerpython_tpu_torch.diff import inverse
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays

    scene = inverse.apply_params(base_scene, params)
    w, h = base_scene.meta.width, base_scene.meta.height
    origins, directions = make_primary_rays(scene.eye, scene.ortho, w, h)
    keep = pixel_ids[::2]
    radiance = render_fn(origins[keep], directions[keep], keep, scene, key)
    return 0.5 * ((radiance - target[keep]) ** 2).mean()


def readings(wl: dict, config: dict, traffic: dict, seeds: list, kind: str,
             device: str) -> list[dict]:
    """The check's numbers on each seed, at the cell's own size: of the
    program (``program``), of the program with half of each step's pixels
    left out of the loss (``fault_half``), or of the reference in bfloat16
    put in the program's place (``control``). Each also gives the worst
    step's loss gap over all the checked steps."""
    import torch

    inf = {"loss1_gap": float("inf"), "grad_gap": float("inf"),
           "change_gap": float("inf")}
    out = []
    for seed in seeds:
        run = Run(wl, config, traffic, seed, device)
        if kind == "control":
            run.raw = scenes.build(config["scene"])
            low = run.reference_fit(torch.bfloat16, device)
            first = {"losses": low[0], "grad1": low[1],
                     "params": {k: v.float() for k, v in low[2].items()},
                     "p0": {k: v.float() for k, v in low[3].items()}}
        else:
            from pathtracerpython_tpu_torch.diff import inverse

            saved = inverse.camera_pixel_loss
            if kind == "fault_half":
                inverse.camera_pixel_loss = _half_batch_loss
            try:
                run.setup()
            finally:
                inverse.camera_pixel_loss = saved
            run.release()
            first = run.first
        ref = run.reference_fit(torch.float32, device)
        row = {"seed": seed}
        row.update({k: v for k, v, _ in compare(first, ref, inf)})
        row["loss_gap_all_steps"] = max(
            abs(a - b) / abs(b) for a, b in zip(first["losses"], ref[0]))
        out.append(row)
        if device != "cpu":
            torch.cuda.empty_cache()
    return out
