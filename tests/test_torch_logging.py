"""The port's run logging (``ssf_slam_tpu_torch/utils/logging.py``) against
the JAX package's RunLogger, on the CPU: the same run.log / metrics.jsonl /
config.json, the TensorBoard writer where ``torch.utils.tensorboard``
imports, and ``profile_trace`` writing a Chrome trace (nothing when given
no directory); these two in a subprocess each."""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import subprocess
import sys


def test_run_logger_files_match_jax(tmp_path):
    from ssf_slam_tpu.utils.logging import RunLogger as JLogger
    from ssf_slam_tpu_torch.config import TrainConfig
    from ssf_slam_tpu_torch.utils.logging import RunLogger

    runs = {}
    for name, cls in (("jax", JLogger), ("port", RunLogger)):
        log = cls(str(tmp_path / name))
        log.cprint("epoch 0")
        log.metrics(3, loss=1.5, epe3d=0.25)
        log.snapshot_config(dict(train=TrainConfig(), n=4))
        log.close()
        runs[name] = tmp_path / name
    for f in ("config.json",):
        assert (runs["jax"] / f).read_text() == (runs["port"] / f).read_text()
    recs = [json.loads((runs[n] / "metrics.jsonl").read_text())
            for n in ("jax", "port")]
    for r in recs:
        r.pop("time")
    assert recs[0] == recs[1]
    assert (runs["port"] / "run.log").read_text().endswith("] epoch 0\n")
    assert dataclasses.asdict(TrainConfig())["lr"] == json.loads(
        (runs["port"] / "config.json").read_text())["train"]["lr"]


def _in_a_process(code: str, tmp_path) -> str:
    """Run ``code`` in a fresh interpreter under a timeout: the TensorBoard
    writer imports TensorFlow where it is installed, and the profiler
    starts its own threads, neither of which belongs in a process that
    also holds JAX."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, TF_CPP_MIN_LOG_LEVEL="3")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=180, check=True)
    return out.stdout


def test_run_logger_tensorboard_writes_events(tmp_path):
    _in_a_process(
        "import sys\n"
        "from ssf_slam_tpu_torch.utils.logging import RunLogger\n"
        "log = RunLogger(sys.argv[1], tensorboard=True)\n"
        "assert log._tb is not None\n"  # torch.utils.tensorboard imports
        "log.metrics(1, loss=2.0)\n"
        "log.metrics(2, loss=1.0)\n"
        "log.close()\n", tmp_path)
    events = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    assert events and os.path.getsize(events[0]) > 0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    _in_a_process(
        "import os, sys, torch\n"
        "from ssf_slam_tpu_torch.utils.logging import profile_trace\n"
        "with profile_trace(None):\n"
        "    torch.ones(4).sum()\n"
        "assert not os.listdir(sys.argv[1])\n"
        "with profile_trace(os.path.join(sys.argv[1], 'prof')):\n"
        "    (torch.ones(64, 64) @ torch.ones(64, 64)).sum()\n", tmp_path)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]
