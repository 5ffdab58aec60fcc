"""The sweep that fixed the stream mix's rate: the stream loop at each
offered rate in one process, on the card:

    python3 portbench/sweep_stream.py --workload ssf.stream \\
        --rates 4,6,8,10,12 --seconds 20 --seed 7

For each rate it prints the scans offered, the 95th percentile of the
latency from due time to pose, the median of the runner's own latency,
and how late the runner picked scans up at the start and at the end of
the window (a lag that grows through the window is a backlog: the rate
is above what the port sustains).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="ssf.stream")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.resolve(args.workload)
    loop = harness.loop_module(spec["mix"])
    cell = loop.Cell(spec["config"], dict(spec["mix"]), args.seed,
                     torch.device("cuda", 0))
    for rate in (float(r) for r in args.rates.split(",")):
        cell.mix["rate_hz"] = rate
        cell.done.clear()
        offered = cell.run_window(args.seconds)
        total, service, lag = cell.latencies()
        tenth = max(len(lag) // 10, 1)
        print(json.dumps(dict(
            rate_hz=rate, offered=offered,
            latency_p95_ms=float(np.percentile(total, 95)),
            latency_p50_ms=float(np.median(total)),
            service_p50_ms=float(np.median(service)),
            lag_first_tenth_ms=float(np.mean(lag[:tenth])),
            lag_last_tenth_ms=float(np.mean(lag[-tenth:])))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
