"""The command's refusals: no card, no program, a JAX module loaded."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import types

import pytest

from portbench import harness

ARGS = ["--workload", "ssf.drive", "--seed", "4294967311", "--seconds", "1",
        "--trace", "0"]


def run_cmd(cwd: str):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_run_exits_nonzero_without_a_card():
    out = run_cmd(harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cmd(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("name,bad", [
    ("ssf_slam_tpu_torch.engine", False), ("ssf_slam_tpu", True),
    ("ssf_slam_tpu.ops.banded", True), ("jax", True), ("jaxlib.xla", True),
    ("jax_bench_fake", False), ("flax.linen", True)])
def test_jax_check_compares_whole_top_level_names(monkeypatch, name, bad):
    clean = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = set(harness.forbidden_modules()) - set(clean)
    assert (name in found) == bad


@pytest.mark.cuda
def test_run_on_the_card_prints_one_result():
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "compared"
