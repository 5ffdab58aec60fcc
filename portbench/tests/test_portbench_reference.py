"""The plain reference held to the port at a small size on the CPU: in
float32 the port's CPU path (its plain versions of the kernels) and the
reference compute the same drive."""

from __future__ import annotations

import copy

import numpy as np
import torch

from portbench import harness
from portbench.gen.synthetic import generate_sequence
from portbench.loops.drive import valid_of
from portbench.reference import build, compare
from portbench.tests.small import small

CPU = torch.device("cpu")


def f32(spec: dict) -> dict:
    spec = copy.deepcopy(spec)
    spec["config"]["flownet"]["dtype"] = "float32"
    return spec


def test_drive_matches_the_port_in_float32():
    from portbench.reference.plain.engine.fused import (
        run_drive, sequence_box)
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused

    from portbench import program

    spec = f32(small("ssf.drive"))
    cfg = spec["config"]
    n = cfg["flownet"]["npoint"]
    frames = generate_sequence(n_frames=3, n_points=n, seed=5, noise=0.004,
                               n_moving=4)
    got = run_sequence_fused(program.load_tflow(cfg, CPU), frames,
                             program.pipeline_config(cfg), device=CPU)
    got["seg"] = got["flow"][..., 3]
    got["static"] = got["seg"] < 0
    box = sequence_box(np.stack([f["pos1"][:n] for f in frames]))
    want = run_drive(build.load_tflow(cfg, CPU), frames,
                     build.pipeline_config(cfg), box, CPU)
    numbers = compare.drive_numbers(got, want, valid_of(frames, n))
    assert numbers["keyframes_differ"] == 0
    assert numbers["static_mismatch"] == 0
    assert numbers["flow_far_share"] == 0
    for key in ("flow_rms_m", "seg_rms", "rel_t_m", "pose_t_m"):
        assert numbers[key] <= 1e-5, (key, numbers)


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; import portbench.reference.plain.engine.fused, "
            "portbench.reference.plain.weights, portbench.reference.compare;"
            " print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = eval(out)
    assert "ssf_slam_tpu_torch" not in tops
    assert not set(tops) & set(harness.FORBIDDEN)
