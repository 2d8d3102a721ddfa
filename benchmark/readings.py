"""The readings a cell's limits are set from, on the chip at the cell's
own size (the benchmark's own runs never run this):

    python3 -m benchmark.readings --workload <cell> --kind <kind> \
        --seeds 1,2,3 [--out FILE]

``--kind program`` reads the check's numbers of sound runs of the system,
``control`` those of the plain reference computed in bfloat16 and put in
the system's place, and a driver's planted faults (``fault_half``: half of
the batch left out) theirs. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    wl, config, traffic = harness.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = harness.driver(traffic["driver"]).readings(
        wl, config, traffic, seeds, args.kind, args.device)
    lines = [json.dumps({"workload": wl["name"], "kind": args.kind, **r})
             for r in rows]
    print("\n".join(lines), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
