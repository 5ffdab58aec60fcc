"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It sets up the cell (inputs and weights from the seed, the program's
model, the warm-up of the cell's shapes), measures for ``--seconds`` (with
``--trace 1``: the loop's traced window under the profiler, for the
per-layer metrics), checks what the window produced against the plain reference,
and prints one JSON object as the last line of standard output; the
compared numbers and their limits go to standard error as its last lines
too. It needs the cards the cell asks for: without them it exits 2 and
prints no result. It runs the PyTorch and CUDA package only: if JAX or the
JAX package has been loaded by the end, it exits 3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    try:
        result, rows = harness.run(
            args.workload, args.seed, args.seconds, bool(args.trace),
            torch.device("cuda", 0), T_START, torch.cuda.device_count())
    except harness.CellError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: JAX modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, value, limit, ok in rows:
        print(f"compared {name} {value!r} limit {limit!r} "
              f"{'ok' if ok else 'OVER'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
