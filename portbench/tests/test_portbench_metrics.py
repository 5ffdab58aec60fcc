"""Each per-layer reader on a recorded sample trace, and the trace's own
arithmetic (busy time, idle gaps by the span open on the host)."""

from __future__ import annotations

import json
import os

import pytest

from portbench import harness, trace

DATA = os.path.join(os.path.dirname(__file__), "data", "sample_trace.json")
WORK = dict(bound_ms=0.001, model_flops=1e9)
EXPECT = {
    "launches_per_scan.serve": 5.0,
    "host_syncs_per_scan.serve": 1.0,
    "network_host_ms_per_scan": 0.14,
    "slam_host_ms_per_scan": 0.195,
    "kernels_roofline.serve": 100.0 * 2e-3 / 0.09,
    "device_idle_share.serve": 100.0 * (1 - 102.0 / 1000.0),
    "step_mfu.serve": 100.0 * 2e9 / 1e-3 / 989e12,
    "stream_service_ms_p50": 150.0,
    "stream_lag_ms_p95": 1.0,  # numpy's linear 95th percentile
}


def sample() -> trace.Context:
    d = json.load(open(DATA))
    tr = trace.Trace([tuple(k) for k in d["kernels"]],
                     [tuple(c) for c in d["copies"]],
                     [tuple(r) for r in d["runtime"]],
                     [tuple(s) for s in d["spans"]])
    return trace.Context(tr, d["units"], WORK,
                         dict(service_ms=[100.0, 150.0, 200.0],
                              lag_ms=[0.0] * 19 + [20.0]))


def test_every_metric_has_an_expectation():
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    readers = {f[:-3] for f in os.listdir(os.path.join(harness.HERE,
                                                       "metrics"))
               if f.endswith(".py")}
    assert {m["name"] for m in bench["per_layer"]} <= readers == set(EXPECT)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_on_sample_trace(name):
    got = harness.metric_reader(name)(sample())
    assert got == pytest.approx(EXPECT[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_finds_nothing_in_empty_trace(name):
    empty = trace.Context(trace.Trace([], [], [], [("pb.window", 0, 10)]),
                          2, WORK)
    got = harness.metric_reader(name)(empty)
    if name.startswith("step_mfu"):  # counted work over the window
        assert got > 0
    else:
        assert got is None


def test_breakdown_labels_gaps_by_open_span():
    b = sample().breakdown()
    ops = dict(b["device_ops"])
    assert ops["kernel_0"] == pytest.approx(40e-6)
    gaps = dict(b["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(898e-6)
    # slam_step spans 230-420 and 600-800 us: idle all through but for
    # the copy at 645-647 us
    assert gaps["pb.slam_step"] == pytest.approx(
        (420 - 230 - 25) * 1e-6 + (800 - 600 - 2) * 1e-6, rel=0.2)
