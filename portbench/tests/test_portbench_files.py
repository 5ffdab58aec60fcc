"""BENCHMARK.json holds to the benchmark's contract, and every cell,
configuration, mix and metric it names resolves to files of its own."""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest

from portbench import harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/")
        names.add(c["name"])
    assert names == {w["config"] for w in BENCH["workloads"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(CELLS) == len(set(CELLS))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads", CELLS)
            assert cell in reports, (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    spec = harness.resolve(cell)
    loop = harness.loop_module(spec["mix"])
    assert hasattr(loop, "Cell")
    assert spec["cell"]["limits"]
    names = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_source(cfg):
    data = json.load(open(os.path.join(harness.ROOT, cfg["file"])))
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert os.path.isfile(os.path.join(harness.ROOT, data["weights"]))


def test_speed_profile_at_one_speed_is_the_serpentine():
    from portbench.gen.synthetic import _serpentine, speed_profile

    traj = speed_profile([1.2], 10)
    for k in range(11):
        pos, yaw = traj(k)
        want_pos, want_yaw = _serpentine(k, 10)
        assert np.allclose(pos, want_pos, atol=1e-12)
        assert yaw == pytest.approx(want_yaw, abs=1e-12)


@pytest.mark.parametrize("mix", sorted(
    {w["traffic"] for w in BENCH["workloads"]}))
def test_mix_speeds_cross_the_keyframe_gate(mix):
    """By the true motion, some scans of a drive are keyframes and some
    are not, so ``keyframes_differ`` has decisions to compare."""
    from portbench.reference.plain.config import MappingConfig

    speeds = harness.load_json(harness.HERE, "traffic", f"{mix}.json")[
        "speeds"]
    gate = MappingConfig().keyframe_trans_gate
    moved, kinds = 0.0, set()
    for v in np.resize(speeds, 32):
        moved += v
        kinds.add(moved >= gate)
        moved = 0.0 if moved >= gate else moved
    assert kinds == {True, False}
