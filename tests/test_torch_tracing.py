"""The port's own tracing (``utils/logging.py::span``) and the streaming
runner's per-scan stamps, on the CPU at 1024 points (the small TFlow with
the committed weights, float32, banded; the default SLAM step).

- Under ``torch.profiler``, ``run_sequence_fused`` records one ``ssf.step``
  a scan, with ``ssf.tower`` and ``ssf.head`` inside it (the first tower,
  ``make_carry``'s, before it) and ``ssf.features``, ``ssf.ego_motion``,
  ``ssf.seg_gate`` and ``ssf.mapping`` inside ``ssf.slam_step``; its outputs
  are bit for bit those of a run nobody profiles. ``StreamingRunner`` under
  the profiler records ``ssf.step``, ``ssf.readback`` and ``ssf.retire``
  once a scan. Its ``ssf.step`` carries the scan's index as the argument
  ``scan`` where the profiler records shapes, and every ``ssf.*`` range is
  a host record (``cpu_op``), not a user annotation, which would put a copy
  of itself on the device's timeline.
- With no profiler active, ``span`` is one shared null context.
- ``StreamingRunner.timings``: pickup <= dispatched <= ready <= retired a
  scan, the held time >= 0, retired - pickup the scan's ``latencies_ms``
  entry, dispatch + ready wait + held = service, and the summary's
  dispatch and held keys computed from them.

The profiled runs go through a fresh interpreter (this file run as a
script), as ``tests/test_torch_logging.py`` runs the exporter: the profiler
starts threads of its own, which do not belong in a process that also
holds JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:  # run as a script
    sys.path.insert(0, REPO)
if HERE not in sys.path:
    sys.path.insert(0, HERE)
import torch_ref  # noqa: E402

N, N_SCANS = 1024, 3


def _setup():
    from ssf_slam_tpu_torch.config import (
        FlowNetConfig,
        LidarConfig,
        PipelineConfig,
    )
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.weights import load_tflow

    torch.set_num_threads(1)
    model = load_tflow(FlowNetConfig(**torch_ref.SMALL_NET), device="cpu")
    frames = generate_sequence(n_frames=N_SCANS, n_points=N, seed=0,
                               noise=0.004, n_moving=4)
    return model, frames, PipelineConfig(lidar=LidarConfig(max_points=N))


def _profiled(out_path: str) -> None:
    """The subprocess: the fused run untraced and under the profiler, and a
    streaming run under the profiler; writes the ``ssf.*`` ranges of each
    profiled run as [name, start us, end us] and whether the two fused
    runs' outputs agree bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused
    from ssf_slam_tpu_torch.engine.streaming import StreamingRunner

    model, frames, cfg = _setup()

    def ranges(prof):
        return sorted([e.name, e.time_range.start, e.time_range.end]
                      for e in prof.events() if e.name.startswith("ssf."))

    plain = run_sequence_fused(model, frames, cfg, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run_sequence_fused(model, frames, cfg, device="cpu")
    identical = all(np.array_equal(plain[k], traced[k]) for k in plain)
    runner = StreamingRunner(model, cfg, device="cpu", pipeline_depth=2)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as sprof:
        runner.run(iter(frames), warmup=False)
    chrome = out_path + ".trace.json"
    sprof.export_chrome_trace(chrome)
    with open(chrome) as f:
        exported = [[e["name"], e.get("cat"), e.get("args", {}).get("scan")]
                    for e in json.load(f)["traceEvents"]
                    if e.get("name", "").startswith("ssf.")]
    with open(out_path, "w") as f:
        json.dump(dict(fused=ranges(prof), stream=ranges(sprof),
                       exported=exported, identical=identical), f)


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tracing") / "ranges.json")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, os.path.abspath(__file__), path],
                   env=env, capture_output=True, text=True, timeout=300,
                   check=True)
    with open(path) as f:
        return json.load(f)


def _named(ranges: list, name: str) -> list:
    return [(s, e) for n, s, e in ranges if n == name]


def _inside(child, parents) -> bool:
    return any(s <= child[0] and child[1] <= e for s, e in parents)


def test_span_is_one_shared_null_context_when_off():
    from ssf_slam_tpu_torch.utils.logging import span

    assert not torch.autograd._profiler_enabled()
    off = span("step", scan=3)
    assert isinstance(off, contextlib.nullcontext)
    assert off is span("tower") is span("slam_step")
    with off:
        pass


def test_profiled_fused_run_is_bit_identical(profiled):
    assert profiled["identical"]


def test_fused_run_records_one_step_a_scan(profiled):
    spans = profiled["fused"]
    assert len(_named(spans, "ssf.step")) == N_SCANS
    assert len(_named(spans, "ssf.head")) == N_SCANS
    assert len(_named(spans, "ssf.slam_step")) == N_SCANS
    # make_carry's tower of the first scan's pair, then one a scan
    assert len(_named(spans, "ssf.tower")) == N_SCANS + 1
    # every scan after the first has a pair to take the motion of
    assert len(_named(spans, "ssf.ego_motion")) == N_SCANS - 1


def test_first_tower_precedes_the_steps(profiled):
    spans = profiled["fused"]
    first = _named(spans, "ssf.tower")[0]
    assert first[1] <= min(s for s, _ in _named(spans, "ssf.step"))


@pytest.mark.parametrize("child,parent", [
    ("ssf.head", "ssf.step"), ("ssf.slam_step", "ssf.step"),
    ("ssf.features", "ssf.slam_step"), ("ssf.ego_motion", "ssf.slam_step"),
    ("ssf.seg_gate", "ssf.slam_step"), ("ssf.mapping", "ssf.slam_step"),
    ("ssf.keyframe", "ssf.mapping")])
def test_fused_spans_nest(profiled, child, parent):
    spans = profiled["fused"]
    kids, parents = _named(spans, child), _named(spans, parent)
    assert kids
    assert all(_inside(c, parents) for c in kids), (child, parent)


def test_towers_of_the_steps_sit_inside_them(profiled):
    spans = profiled["fused"]
    steps = _named(spans, "ssf.step")
    towers = _named(spans, "ssf.tower")[1:]
    assert len(towers) == len(steps)
    assert all(_inside(t, steps) for t in towers)


@pytest.mark.parametrize("name", ["ssf.step", "ssf.readback", "ssf.retire"])
def test_stream_records_its_spans_once_a_scan(profiled, name):
    assert len(_named(profiled["stream"], name)) == N_SCANS


def test_stream_step_holds_the_slam_step(profiled):
    spans = profiled["stream"]
    inner = _named(spans, "ssf.slam_step")
    assert len(inner) == N_SCANS
    assert all(_inside(c, _named(spans, "ssf.step")) for c in inner)


def test_stream_steps_carry_the_scan_index(profiled):
    steps = [scan for name, _, scan in profiled["exported"]
             if name == "ssf.step"]
    assert sorted(steps) == list(range(N_SCANS))


def test_spans_are_host_records_with_no_device_copy(profiled):
    cats = {cat for _, cat, _ in profiled["exported"]}
    assert cats == {"cpu_op"}, cats


@pytest.fixture(scope="module")
def small():
    return _setup()


@pytest.mark.parametrize("depth", [1, 2])
def test_stream_stamps_account_for_the_service_time(small, depth):
    from ssf_slam_tpu_torch.engine.streaming import StreamingRunner

    model, frames, cfg = small
    runner = StreamingRunner(model, cfg, device="cpu", pipeline_depth=depth)
    stats = runner.run(iter(frames))
    recs = runner.timings
    assert [r.scan for r in recs] == list(range(N_SCANS))
    assert len(runner.latencies_ms) == N_SCANS
    for r, lat in zip(recs, runner.latencies_ms):
        assert r.pickup <= r.dispatched <= r.ready <= r.retired
        assert r.held >= 0.0
        assert r.ready == r.dispatched  # on the CPU the copy is done
        assert (r.retired - r.pickup) * 1e3 == lat
        service = r.retired - r.pickup
        parts = (r.dispatched - r.pickup) + (r.ready - r.dispatched) + r.held
        assert parts == pytest.approx(service, abs=1e-9)
    disp = [(r.dispatched - r.pickup) * 1e3 for r in recs]
    held = [r.held * 1e3 for r in recs]
    assert stats["dispatch_ms_mean"] == pytest.approx(np.mean(disp))
    assert stats["dispatch_ms_p95"] == pytest.approx(np.percentile(disp, 95))
    assert stats["held_ms_mean"] == pytest.approx(np.mean(held))
    assert stats["held_ms_p95"] == pytest.approx(np.percentile(held, 95))
    assert stats["latency_ms_mean"] == pytest.approx(
        np.mean(runner.latencies_ms))
    if depth == 1:  # retired as soon as dispatched: nothing waits
        assert max(held) < min(disp)


if __name__ == "__main__":
    _profiled(sys.argv[1])
