"""One run of one benchmark cell: set-up, a measured window, and the
check that what the window produced is correct.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json`` names a configuration (``configs/<config>.json``) and
a traffic mix (``traffic/<mix>.json``); the mix's ``loop`` names the code
that drives it (``loops/<loop>.py``); ``workloads/<cell>.json`` holds the
limits of the cell's comparison; each per-layer metric is read by
``metrics/<metric>.py``. Nothing here lists cells or metrics.

A loop module has ``Cell(config, mix, seed, device)``, whose constructor
is the set-up (inputs from the seed, the program's model, the warm-up of
every shape the traffic uses), and whose methods are:

- ``window(seconds) -> dict``: the measured window; the end-to-end values
  it can give, by metric name, and ``attempted``;
- ``traced(spans, seconds) -> dict``: the traced run's work: a window
  under the profiler with the benchmark's spans around the program's
  layers, and what else the loop's per-layer metrics read; ``ctx``, a
  ``trace.Context`` (the trace, its scans, ``work/``'s count of one scan
  and the loop's own records), and ``attempted``;
- ``release()``: drop the program's state;
- ``compare(quant) -> list of dicts``: the plain reference over what the
  window produced, one dict of compared numbers by name for each unit
  compared (a drive); with ``quant`` (a lower precision) the control in
  the program's place instead.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "ssf_slam_tpu")


class CellError(Exception):
    """The cell cannot run here (no card, a missing file)."""


def load_json(*parts) -> dict:
    path = os.path.join(*parts)
    if not os.path.isfile(path):
        raise CellError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def resolve(cell: str) -> dict:
    """The cell's entry, configuration, mix, limits and per-layer and
    end-to-end metrics, by the names in ``BENCHMARK.json``."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise CellError(f"no workload {cell!r} in BENCHMARK.json")
    entry = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT, configs[entry["config"]]["file"])
    mix = load_json(HERE, "traffic", f"{entry['traffic']}.json")

    def mine(metric):
        return cell in metric.get("workloads", [cell])

    return dict(entry=entry, config=config, mix=mix,
                cell=load_json(HERE, "workloads", f"{cell}.json"),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def loop_module(mix: dict):
    return importlib.import_module(f"portbench.loops.{mix['loop']}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise CellError(f"no reader portbench/metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``ssf_slam_tpu_torch`` is not ``ssf_slam_tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str | None:
    """``nvidia-smi``'s power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def within(value: float, limit) -> bool:
    return limit is not None and value == value and value <= limit


def verdict(units: list, limits: dict) -> tuple[bool, list, int]:
    """Each number that the cell's limits name, the worst over the units,
    against its limit: (all within, rows of (name, worst value, limit,
    ok), units out of a limit). A run that compared nothing, or lacks a
    number its limits name, is not correct."""
    rows = []
    for name, limit in limits.items():
        values = [u.get(name, float("nan")) for u in units]
        worst = max(values) if values else float("nan")
        if any(v != v for v in values):
            worst = float("nan")
        rows.append((name, worst, limit, within(worst, limit)))
    failed = sum(1 for u in units
                 if not all(within(u.get(k, float("nan")), lim)
                            for k, lim in limits.items()))
    return bool(units) and all(r[3] for r in rows), rows, failed


def run(cell: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, chips_available: int, spec: dict | None = None):
    """One run; returns the result line's object and the comparison rows.
    ``spec`` replaces ``resolve(cell)`` (the tests' small cells)."""
    import torch

    spec = spec or resolve(cell)
    need = int(spec["entry"]["chips"])
    if device.type == "cuda" and chips_available < need:
        raise CellError(f"{cell} needs {need} cards, {chips_available} here")
    loop = loop_module(spec["mix"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    runner = loop.Cell(spec["config"], spec["mix"], seed, device)
    setup_s = time.perf_counter() - t_start
    metrics, dev_extra, breakdown = {}, {}, None
    if trace:
        from portbench import trace as tr

        got = runner.traced(tr.Spans(), seconds)
        ctx = got["ctx"]
        for m in spec["per_layer"]:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
        dev_extra = dict(busy_s=ctx.busy_s, window_s=ctx.window_s)
        breakdown = ctx.breakdown()
        attempted = got["attempted"]
    else:
        got = runner.window(seconds)
        values = dict(got, setup_s=setup_s)
        for m in spec["end_to_end"]:
            if m["name"] not in values:
                raise CellError(f"{cell} gives no {m['name']}")
            metrics[m["name"]] = dict(value=float(values[m["name"]]),
                                      unit=m["unit"])
        attempted = got["attempted"]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    runner.release()
    correct, rows, failed = verdict(runner.compare(None),
                                    spec["cell"]["limits"])
    result = dict(correct=correct, attempted=int(attempted),
                  failed=int(failed), metrics=metrics,
                  device=dict(platform="gpu" if device.type == "cuda"
                              else device.type,
                              kind=(torch.cuda.get_device_name(device)
                                    if device.type == "cuda" else "cpu"),
                              count=need, memory_peak_bytes=int(peak),
                              power_limit=power_limit(), **dev_extra))
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {name: dict(value=value, limit=limit)
                          for name, value, limit, _ in rows}
    return result, rows
