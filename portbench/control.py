"""The readings that the limits of ``workloads/<cell>.json`` are set
from, on the card at the cell's own size, for several seeds in one
process:

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 5 [--control]

For each seed it sets the cell up, runs a short window at the cell's own
load, and prints the program's compared numbers against the plain
reference (``program`` lines); with ``--control`` also the controls the
mix names (``controls``, fp8 by default) in the program's place: "fp8",
the reference network with its Dense layers through fp8 (e4m3, one scale
a tensor), the next precision below the configuration's bf16; "tf32", the reference SLAM step with its
float32 products in TF32, the next below the geometry's float32 with TF32
off. The benchmark's own runs never run a control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import faults  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(faults.ALL),
                   help="plant a fault in the program (faults.py) and print "
                        "its readings instead of a sound run's")
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    spec = harness.resolve(args.workload)
    loop = harness.loop_module(spec["mix"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        planted = faults.Planter()
        if args.fault:
            faults.ALL[args.fault](planted)
        cell = loop.Cell(spec["config"], spec["mix"], seed, dev)
        cell.window(args.seconds)
        planted.undo()
        cell.release()
        sides = ["program"] + (list(spec["mix"].get("controls", ["fp8"]))
                               if args.control else [])
        label = {"program": args.fault or "program"}
        for side in sides:
            units = cell.compare(None if side == "program" else side)
            worst = {k: max(u[k] for u in units) for k in units[0]}
            print(json.dumps(dict(side=label.get(side, side), seed=seed,
                                  units=len(units),
                                  **worst)),
                  flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
