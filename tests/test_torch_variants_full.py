"""The full-width variant runs against the JAX package, on the CPU: the
first 2 of the 8 bench frames (8192 points, f32, committed weights) of
each run of ``tests/fixtures/torch_port/variants_ref.npz`` (SF fused, SF
fused with ``geom_refine``, SSF fused with ``geom_refine``, and SEG,
NO_SEG and ONLY_PC on the ground-truth flow), as
tests/test_torch_slam.py holds the SSF step's: poses within 1e-4 m /
1e-5, is_keyframe / n_features / n_dyn_over equal. The chip check holds
all 8 frames on the card. The fixture is made by

      JAX_PLATFORMS=cpu python tests/test_torch_variants.py --make-fixture full
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402
from test_torch_variants import (  # noqa: E402
    FULL_REF,
    FULL_RUNS,
    _assert_run,
    _port_run,
    _with_exact_gt,
    bench_frames,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _xla_cpu_knn(monkeypatch):
    torch_ref.round_knn_like_xla_cpu(monkeypatch)


@pytest.fixture(scope="module")
def full_ref():
    with np.load(FULL_REF) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", list(FULL_RUNS))
def test_full_width_variant_first_frames_match_fixture(full_ref, name):
    from ssf_slam_tpu_torch.engine.fused import sequence_box, stack_fused_scans

    frames = _with_exact_gt(bench_frames())
    # the fixture's fused runs took the Morton box of its 8 frames
    box = sequence_box(stack_fused_scans(frames, 8192)["points"])
    net = dict(npoint=8192, joint_seg=True, neighbor_backend="banded")
    got = _port_run(FULL_RUNS[name], frames[:2], 8192, {}, net=net,
                    box=box)
    want = {k.split("/", 1)[1]: v for k, v in full_ref.items()
            if k.startswith(name + "/")}
    _assert_run(got, want, 2, name)
