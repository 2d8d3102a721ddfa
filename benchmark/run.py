"""Run one cell of the benchmark and print its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the scene, the kernels' build on a checkout's first run,
warm-up) counts as ``setup_s``. With ``--trace 0`` the window measures the
cell's end-to-end metrics; with ``--trace 1`` the same window runs, and then
a few units of work under ``torch.profiler`` give the per-layer metrics.
After the window the program's state is freed and the plain reference
checks its outputs; each number compared and its limit are printed as the
last lines on standard error and under ``checks`` in the result line. A run
without enough CUDA devices, with JAX or the JAX package loaded, or outside
a checkout that holds the system, prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

from benchmark import harness  # noqa: E402


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    args = _args(argv)
    bench = harness.benchmark()
    wl, config, traffic = harness.cell(args.workload, bench)

    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < wl["chips"]:
        _fail(f"{wl['name']} needs {wl['chips']} devices, "
              f"{torch.cuda.device_count()} found")
    try:
        import pathtracerpython_tpu_torch as program
    except ImportError as e:
        _fail(f"the system is not in this checkout: {e}")
    if not harness.program_inside_checkout(program):
        _fail(f"{harness.PROGRAM} comes from {program.__file__}, outside "
              f"the checkout {harness.ROOT}")

    run = harness.driver(traffic["driver"]).Run(wl, config, traffic,
                                                args.seed, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    run.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    metrics, attempted, failed, info = run.window(args.seconds)
    print(info, flush=True)
    breakdown = None
    if args.trace:
        from benchmark import trace

        traced = run.traced()
        summary = trace.summarize(
            traced.pop("events"), traced["window_s"],
            trace.port_kernel_names(os.path.dirname(program.__file__)))
        summary.update(traced)
        breakdown = trace.breakdown(summary)
        out = {}
        for m in harness.cell_metrics(bench, wl["name"], "per_layer"):
            value = harness.metric_reader(m["name"])(summary)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"]
                 for m in harness.cell_metrics(bench, wl["name"],
                                               "end_to_end")}
        metrics["setup_s"] = setup_s
        out = {k: {"value": v, "unit": units[k]} for k, v in metrics.items()
               if k in units}
    # read before the reference runs: a process's peak never falls again
    device = harness.device_info(wl["chips"])
    if args.trace:
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])

    run.release()
    torch.cuda.empty_cache()
    checks = run.check(harness.limits(wl["name"]), "cuda")
    correct = harness.is_correct(checks)

    found = harness.loaded_forbidden()
    if found:
        _fail(f"modules loaded that the run may not load: {found}", 3)
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct, attempted, failed, out, device,
                              checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
