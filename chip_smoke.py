"""Chip smoke test of the PyTorch + CUDA port (``ssf_slam_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package. Phases, each
printing its own line and failing loudly:

1. build: compile every CUDA source of the port with nvcc (all at once,
   beside three measurement builds of band_knn.cu with the split S fixed at
   8, 16 and 32), check in nvcc's -Xptxas -v report (kept beside each
   library) that every knn_group / knn_idw instance has a 0-byte stack
   frame and no spills (printing the shipped library's lines) and print the
   card's name and power limit;
2. kernels: each of the nine kernels at its largest main-path shape, on
   Morton-sorted clouds of the bench sequence (the cost attention on the
   level-0 cost volume's own inputs, with the folded weightnet of the
   committed flow0_r), held against its plain PyTorch version on the card
   (exact: idx, sqdist, grouped, regroup; knn_idw's bf16 output to one bf16
   rounding step, 2^-8 relative + 1e-6 absolute; scatter_softmax_sum to
   1e-5 relative + 1e-5 absolute for the atomics' run-to-run order;
   cost_attention as stated and justified at COST_ATTENTION_TOL; knn and
   knn_group2 exact; scatter_add as the scatter; attention as stated at
   ATTENTION_TOL), and timed with CUDA
   events beside the plain version, one PyTorch library call where one
   computes the same function, and the bound of the card. Then
   knn_group and knn_idw, redesigned for the card, at every distinct shape
   their wrappers receive in a 2-frame run of the main path (batch 1), and
   at the level-0 shapes at batch 1 and 4, warm and with the L2 flushed
   before each launch: exact against the plain version (knn_idw's output as
   above; float32 to 1e-5 relative) with the split S (lanes per query) the
   shipped library picks and with each measurement build's; timed as above
   and, to compare the splits, alone (queued behind a device-side sleep, so
   that no host work is timed) with each;
3. f32: the committed weights over the first 8 bench frames through the
   whole SSF step against the JAX reference fixtures
   (tests/fixtures/torch_port/ssf_fused_ref.npz, ssf_slam_ref.npz):
   per-frame rel_t and pose_t within 1e-2 m, rotations within 1e-3 rad,
   is_keyframe and n_features equal, and a mean end-point difference of
   frame 1's finest flow within 1e-2 m, for fuse_attention off and on;
4. the main path, fuse_attention off: the bench operating point, 32 frames
   x 8192 points, bf16, tower caching, the whole step, launch counters
   reset just before and read just after; finite outputs, every counter
   equal to its expected count, scans/s, the keyframe count and the ATE of
   the map pose (pose_t) and of the odometry (odom_t) against the
   generator's ground-truth poses;
5. the main path with fuse_attention on: the same 32 frames and checks,
   with two cost_attention launches per scan;
6. entry: the neighbour engine's and the attention module's remaining
   entry points (nn_knn, nn_knn_group2 and attention_fused, the last two
   with their gradients) at the level-0 shapes, counters reset just before
   and read just after: one launch each of knn, knn_group2 and attention,
   two of scatter_add;
7. train: the training path at full width (8192 points, joint seg, bf16,
   banded, batch 4), warm-started from the committed weights with a fresh
   optimizer, on a corpus of 2 worlds x 4 frames with label weights: the
   forward's and the backward's launches of one step; a few steps of the
   train loop (counters reset just before and read just after; steps/s,
   samples/s, peak memory), one eval pass (EPE, mIoU); the loss on one
   fixed batch falling over 8 steps at TRAIN_LR; the first step's f32
   gradients with the backward's scatter_add against its plain version;
   and the f32 train step against the JAX fixture
   tests/fixtures/torch_port/ssf_train_ref.npz (loss 1e-4 relative, each
   leaf's gradient norm 1e-3 relative, the new batch statistics 1e-4).

With ``--profile DIR`` it then runs phases 5 and 4 three times more in
turns (so that each setting runs first as often as the other) and prints
their scans/s side by side, traces 8 scans of each main path with
torch.profiler, writes device time by kernel to DIR/profile_<name>.txt and
counts the host syncs per scan by the port's source lines; phase 7 then
also traces two train steps (DIR/profile_train.txt). With ``--serve NPZ``
it only builds and runs phase 4 with the weights of NPZ (a ``best.npz`` of
``python -m ssf_slam_tpu_torch.train.train_ssf``).

The last two lines of standard output are the kernels JSON object and the
result JSON object; the card's name and power limit come before them.
Exits nonzero, printing no result, when CUDA is absent or any phase fails
(a failed check raises; nothing catches it).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

N_POINTS, N_FRAMES, N_FIXTURE_FRAMES = 8192, 32, 8
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, non-tensor
# f32, bf16 tensor cores
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
SLEEP_HZ = 2.0e9  # cycles per second of torch.cuda._sleep, >= the SM clock
FIXTURES = os.path.join("tests", "fixtures", "torch_port")
FIXTURE = os.path.join(FIXTURES, "ssf_fused_ref.npz")
SLAM_FIXTURE = os.path.join(FIXTURES, "ssf_slam_ref.npz")

# banded-kernel launches of the bench config (band_params at 8192 points):
# per scan, one tower (sa1, sa2, su1, su0 -> 4 knn_group) and one head
# (2 cost volumes x 2 knn_group, 2 x 3 knn_idw, 2 scatter, 2 regroup);
# make_carry adds one tower
PER_SCAN = {"knn_group": 8, "knn_idw": 6, "scatter_softmax_sum": 2,
            "regroup": 2}
PER_TOWER = {"knn_group": 4, "knn_idw": 0, "scatter_softmax_sum": 0,
             "regroup": 0}
# the fused cost attention runs in the two banded cost volumes (flow0_r at
# 8192 points, flow1_r at 2048) when fuse_attention is on
PER_SCAN_FUSED = {"cost_attention": 2}
# one train step at 8192 points (batch 4, no tower caching): the forward
# runs both towers (4 knn_group each) and one head (2 banded cost volumes:
# 2 knn_group, 1 scatter, 1 regroup each; 6 knn_idw); the backward sums
# segments for each grouping whose features carry gradient (12), each
# regroup (2) and each IDW upsampling (4): point_warping's 2 IDW calls get
# no cotangent, as the warped cloud only feeds a kNN's indices
PER_STEP_FWD = {"knn_group": 12, "knn_idw": 6, "scatter_softmax_sum": 2,
                "regroup": 2}
PER_STEP_BWD = {"scatter_add": 18}
# the entry-point phase: one call of each, with gradients where they have
PER_ENTRY = {"knn": 1, "knn_group2": 1, "attention": 1, "scatter_add": 2}
TRAIN_BATCH, TRAIN_LR, TRAIN_STEPS, DESCENT_STEPS = 4, 1e-4, 4, 8
TRAIN_FIXTURE = os.path.join(FIXTURES, "ssf_train_ref.npz")

KERNELS = {  # name -> (CUDA source, the Pallas call it replaces)
    "knn_group": ("ssf_slam_tpu_torch/csrc/band_knn.cu",
                  "ssf_slam_tpu/ops/banded.py:324"),
    "knn_idw": ("ssf_slam_tpu_torch/csrc/band_knn.cu",
                "ssf_slam_tpu/ops/banded.py:539"),
    "scatter_softmax_sum": ("ssf_slam_tpu_torch/csrc/band_scatter.cu",
                            "ssf_slam_tpu/ops/banded.py:758"),
    "regroup": ("ssf_slam_tpu_torch/csrc/band_scatter.cu",
                "ssf_slam_tpu/ops/banded.py:613"),
    "cost_attention": ("ssf_slam_tpu_torch/csrc/cost_attention.cu",
                       "ssf_slam_tpu/ops/attention.py:287"),
    "knn": ("ssf_slam_tpu_torch/csrc/band_knn.cu",
            "ssf_slam_tpu/ops/banded.py:228"),
    "knn_group2": ("ssf_slam_tpu_torch/csrc/band_knn.cu",
                   "ssf_slam_tpu/ops/banded.py:430"),
    "attention": ("ssf_slam_tpu_torch/csrc/attention.cu",
                  "ssf_slam_tpu/ops/attention.py:90"),
    "scatter_add": ("ssf_slam_tpu_torch/csrc/band_scatter.cu",
                    "ssf_slam_tpu/ops/banded.py:709"),
}
# cost_attention against its plain version on the card, bf16. The kernel
# sums in its own order (sequential FMAs) and the plain version in
# cuBLAS's, so a float32 sum one ulp apart can round an intermediate (the
# dual-softmax product, an attended feature, a hidden unit) to the other
# neighbouring bf16 value; the output then moves by about one bf16 step of
# the intermediate's scale, not of its own value. The inputs themselves
# vary from run to run in their last bits (the network's float32 atomics),
# and so does the tail of the differences. Phase 2 prints the agreement it
# measures on the level-0 inputs; PERF.md records it. Held, with room for
# that tail: cost_fwd within one bf16 step of its value (2^-8 relative +
# 1e-6) on at least 99.95 % of the elements and within four steps of
# (|value| + rms) everywhere; w_k within 1e-3 on at least 99.95 % and 1e-2
# everywhere. A wrong kernel misses on most elements.
COST_ATTENTION_TOL = dict(cf_rel=2.0 ** -8, cf_abs=1e-6, cf_all=2.0 ** -6,
                          wk_abs=1e-3, wk_all=1e-2, share=0.9995)
# attention against its plain version, bf16: the outputs round once from a
# float32 sum that the two take in different orders, so a sum near a
# rounding boundary lands on the neighbouring bf16 value: held within one
# bf16 step (2^-7 of the value) on 99.99 % of the elements and within two
# steps of (|value| + rms) everywhere, as tests/test_torch_cuda.py holds it
ATTENTION_TOL = dict(step=2.0 ** -7, share=0.9999, all_steps=2.0)


class PhaseError(RuntimeError):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, phase: str, msg: str) -> None:
    if not ok:
        raise PhaseError(f"{phase}: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches that the host queues
    behind a device-side sleep longer than its own time to queue them, so
    that the events time the kernels alone, not a wrapper's host work
    (which cuda_ms counts where it outlasts a small kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(iters * host_s + 1e-3, 1.0) * SLEEP_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters: int = 10) -> float:
    """Mean device time of one fn() with a cold L2: before each launch a
    256 MB write (above the card's 50 MB of L2) evicts its inputs; events
    around each launch. As in cuda_ms, the host queues the launch while the
    device works (here on the write), so its work counts only where it
    outlasts that."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    pairs = []
    torch.cuda.synchronize()
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound(nbytes: float, flops: float,
          peak_ops: float = PEAK_F32) -> tuple[float, str]:
    """The least time (ms) for the work and what sets it: bytes over the
    memory rate or operations over ``peak_ops`` (f32 CUDA cores for the
    banded kernels, whose work is not matmul; bf16 tensor cores for the
    cost attention's products)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def group_bound(b, n, m, k, c, esize, wb) -> tuple[float, str]:
    """knn_group's bound: clouds, feats, sqdist + idx and the grouped rows
    moved once; 8 operations per band candidate."""
    return bound(b * ((n + m) * 3 * 4 + m * c * esize + n * k * (2 * 4)
                      + n * k * c * esize), b * n * wb * 8)


def idw_bound(b, n, m, k, c, esize, wb) -> tuple[float, str]:
    """knn_idw's bound: clouds, feats, the [N, C] output and sqdist + idx
    moved once; 8 operations per band candidate, 2 per mixed element."""
    return bound(b * ((n + m) * 3 * 4 + m * c * esize + n * c * esize
                      + n * k * (2 * 4)), b * (n * wb * 8 + n * k * c * 2))


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


# lanes per query that the measurement builds of band_knn.cu fix for
# knn_group and knn_idw (the shipped library picks S by query count)
SPLITS = (8, 16, 32)
SPLIT_BUILDS = tuple(("ssf_band_knn", (f"SSF_KNN_SPLIT={s}",))
                     for s in SPLITS)
NO_FRAME = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"


def check_frames(label: str, log: str) -> list[str]:
    """Checks that every knn_group_kernel / knn_idw_kernel entry of an
    ``nvcc -Xptxas -v`` report has a 0-byte stack frame and no spills;
    returns the entries' lines."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for (\S+)", line)
        if m and ("knn_group_kernel" in m.group(1)
                  or "knn_idw_kernel" in m.group(1)):
            frame = lines[i + 1].strip() if i + 1 < len(lines) else ""
            check(frame == NO_FRAME, "build", f"{label}: {m.group(1)}: {frame}")
            out.append(f"{m.group(1)}: {frame}")
    return out


def phase_build() -> str:
    from ssf_slam_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all(variants=SPLIT_BUILDS)
    for name, defines in [("ssf_band_knn", ())] + list(SPLIT_BUILDS):
        entries = check_frames(name + "".join(f" -D{d}" for d in defines),
                               cuda_build.ptxas_report(name, defines))
        # K 3, 5, 7, 8, 16, 32 x two element types x two kernels, and x S
        # 8, 16, 32 in the shipped library
        check(len(entries) == (24 if defines else 72), "build",
              f"{name} {defines}: {len(entries)} knn_group / knn_idw entries")
        if not defines:
            for line in entries:
                say("build", f"{name}: {line}")
        else:
            say("build", f"{name} -D{defines[0]}: {len(entries)} knn_group "
                f"/ knn_idw entries, each {NO_FRAME}")
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    for name, defines in SPLIT_BUILDS:
        cuda_build.load(name, defines)
    say("build", f"{len(cuda_build.SOURCES)} libraries ready in "
        f"{time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return smi


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def bench_frames(n: int = N_FRAMES):
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    return generate_sequence(n_frames=N_FRAMES, n_points=N_POINTS, seed=0,
                             noise=0.004, n_moving=4)[:n]


def phase_kernels(frames, dev) -> dict:
    """Returns {name: kernel record without launches}."""
    from ssf_slam_tpu_torch.ops import banded
    from ssf_slam_tpu_torch.ops import neighbors as nb

    pc1, pc2, box = sorted_pair(frames, dev)
    sparse2 = pc2[:, ::4].contiguous()  # a sorted 2048-point level-1 cloud
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    out = {}
    f32, bf16 = 4, 2

    # knn_group: level-0 cost volume, 8192 x 8192, k = 16, C = 3 + 96 f32
    k, c = 16, 99
    feats = randn(1, N_POINTS, c)
    params = nb.band_params(N_POINTS, N_POINTS, k)
    plan = nb.make_plan(pc1, pc2, params, 64.0, box)
    got = banded.knn_group(pc1, pc2, feats, k, plan, params)
    want = banded.knn_group_plain(pc1, pc2, feats, k, plan, params)
    check(torch.equal(got[1], want[1]), "kernels", "knn_group idx differ")
    check(torch.equal(got[0], want[0]), "kernels", "knn_group sqdist differ")
    check(torch.equal(got[2], want[2]), "kernels", "knn_group grouped differ")
    wb = params[1] * params[2]
    n, m = N_POINTS, N_POINTS
    out["knn_group"] = dict(
        max_abs_err=0.0, shape=f"{n}x{m} k={k} C={c} f32",
        ms=cuda_ms(lambda: banded.knn_group(pc1, pc2, feats, k, plan,
                                            params)),
        plain_ms=cuda_ms(lambda: banded.knn_group_plain(
            pc1, pc2, feats, k, plan, params)),
        library_ms=None, bound=group_bound(1, n, m, k, c, f32, wb))
    idx_l0, plan_l0, params_l0 = got[1], plan, params

    # knn_idw: level-0 upsample_multi, 8192 <- 2048, k = 7, C = 132 bf16
    k, c, m = 7, 132, sparse2.shape[1]
    fields = randn(1, m, c, dtype=torch.bfloat16)
    params = nb.band_params(N_POINTS, m, k)
    plan = nb.make_plan(pc1, sparse2, params, 64.0, box)
    got = banded.knn_idw(pc1, sparse2, fields, k, plan, params)
    want = banded.knn_idw_plain(pc1, sparse2, fields, k, plan, params)
    check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
          "kernels", "knn_idw sqdist/idx differ")
    # one bf16 rounding step: float32 sums that differ in the last bit may
    # round to neighbouring bf16 values
    err = (got[0].float() - want[0].float()).abs()
    check(bool((err <= 1e-6 + 2.0 ** -8 * want[0].float().abs()).all()),
          "kernels", f"knn_idw out differs by {err.max().item()}")
    wb = params[1] * params[2]
    out["knn_idw"] = dict(
        max_abs_err=err.max().item(), shape=f"{n}x{m} k={k} C={c} bf16",
        ms=cuda_ms(lambda: banded.knn_idw(pc1, sparse2, fields, k, plan,
                                          params)),
        plain_ms=cuda_ms(lambda: banded.knn_idw_plain(
            pc1, sparse2, fields, k, plan, params)),
        library_ms=None, bound=idw_bound(1, n, m, k, c, bf16, wb))

    # scatter_softmax_sum and regroup: level-0 cost volume, N = 8192,
    # K = 16, C = 64 bf16, under the knn_group plan above
    k, c = 16, 64
    vals = randn(1, N_POINTS, k, c, dtype=torch.bfloat16)
    w = randn(1, N_POINTS, k)
    w_shift = (w - w.max()).contiguous()
    got = banded.scatter_softmax_sum(idx_l0, vals, w_shift, plan_l0,
                                     params_l0, N_POINTS)
    want = banded.scatter_softmax_sum_plain(idx_l0, vals, w_shift, plan_l0,
                                            params_l0, N_POINTS)
    err = (got - want).abs()
    check(bool((err <= 1e-5 + 1e-5 * want.abs()).all()), "kernels",
          f"scatter_softmax_sum differs by {err.max().item()}")
    aug = torch.cat([vals.float() * w_shift.exp()[..., None],
                     w_shift.exp()[..., None]], -1).to(torch.bfloat16)
    aug = aug.float().reshape(-1, c + 1)
    flat_idx = idx_l0.reshape(-1).long()
    acc = torch.zeros(N_POINTS, c + 1, device=dev)
    out["scatter_softmax_sum"] = dict(
        max_abs_err=err.max().item(), shape=f"N={n} K={k} C={c} bf16",
        ms=cuda_ms(lambda: banded.scatter_softmax_sum(
            idx_l0, vals, w_shift, plan_l0, params_l0, N_POINTS)),
        plain_ms=cuda_ms(lambda: banded.scatter_softmax_sum_plain(
            idx_l0, vals, w_shift, plan_l0, params_l0, N_POINTS)),
        library_ms=cuda_ms(lambda: acc.index_add_(0, flat_idx, aug)),
        bound=bound(n * k * 4 + n * k * c * bf16 + n * k * f32
                    + N_POINTS * (c + 1) * f32, n * k * (c + 1) * 3))

    cost = randn(1, N_POINTS, c, dtype=torch.bfloat16)
    got = banded.regroup(idx_l0, cost, plan_l0, params_l0)
    want = banded.regroup_plain(idx_l0, cost, plan_l0, params_l0)
    check(torch.equal(got, want), "kernels", "regroup differs")
    out["regroup"] = dict(
        max_abs_err=0.0, shape=f"[{n},{k}] x [{N_POINTS},{c}] bf16",
        ms=cuda_ms(lambda: banded.regroup(idx_l0, cost, plan_l0, params_l0)),
        plain_ms=cuda_ms(lambda: banded.regroup_plain(idx_l0, cost, plan_l0,
                                                      params_l0)),
        library_ms=cuda_ms(lambda: torch.index_select(cost[0], 0, flat_idx)),
        bound=bound(n * k * 4 + N_POINTS * c * bf16 + n * k * c * bf16, 0))

    # knn: the level-0 searches' top-k alone, 8192 x 8192, k = 16
    k, n, m = 16, N_POINTS, N_POINTS
    got = banded.knn(pc1, pc2, k, plan_l0, params_l0)
    want = banded.knn_plain(pc1, pc2, k, plan_l0, params_l0)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "kernels", "knn sqdist/idx differ")
    wb = params_l0[1] * params_l0[2]
    out["knn"] = dict(
        max_abs_err=0.0, shape=f"{n}x{m} k={k} f32",
        ms=cuda_ms(lambda: banded.knn(pc1, pc2, k, plan_l0, params_l0)),
        plain_ms=cuda_ms(lambda: banded.knn_plain(pc1, pc2, k, plan_l0,
                                                  params_l0)),
        library_ms=None,  # no one call computes a banded top-k
        bound=bound((n + m) * 3 * f32 + n * k * (2 * 4), n * wb * 8))

    # knn_group2: the cost volume's twin searches, query xyz1 + coarse
    # flow and xyz1, targets xyz2 and a warped copy of it, feats
    # xyz2 || points2 (C = 99 f32), under the plan of the first pair
    c = 99
    qb = (pc1 + 0.05 * randn(1, N_POINTS, 3)).contiguous()
    pb = (pc2 + 0.05 * randn(1, N_POINTS, 3)).contiguous()
    feats = randn(1, N_POINTS, c)
    got = banded.knn_group2(pc1, qb, pc2, pb, feats, k, plan_l0, params_l0)
    want = banded.knn_group2_plain(pc1, qb, pc2, pb, feats, k, plan_l0,
                                   params_l0)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "kernels",
          "knn_group2 outputs differ")
    out["knn_group2"] = dict(
        max_abs_err=0.0, shape=f"2x {n}x{m} k={k} C={c} f32",
        ms=cuda_ms(lambda: banded.knn_group2(pc1, qb, pc2, pb, feats, k,
                                             plan_l0, params_l0)),
        plain_ms=cuda_ms(lambda: banded.knn_group2_plain(
            pc1, qb, pc2, pb, feats, k, plan_l0, params_l0)),
        library_ms=None,
        bound=bound(2 * (n + m) * 3 * f32 + m * c * f32
                    + 2 * (n * k * (2 * 4) + n * k * c * f32),
                    2 * n * wb * 8))

    # scatter_add: the backward of the level-0 cost volume's grouping, the
    # f32 cotangent [8192, 16, 99] summed into 8192 rows
    vals = randn(1, N_POINTS, k, c)
    got = banded.scatter_add(idx_l0, vals, plan_l0, params_l0, N_POINTS)
    want = banded.scatter_add_plain(idx_l0, vals, plan_l0, params_l0,
                                    N_POINTS)
    err = (got - want).abs()
    check(bool((err <= 1e-5 + 1e-5 * want.abs()).all()), "kernels",
          f"scatter_add differs by {err.max().item()}")
    flat_vals = vals.reshape(-1, c)
    acc = torch.zeros(N_POINTS, c, device=dev)
    out["scatter_add"] = dict(
        max_abs_err=err.max().item(), shape=f"N={n} K={k} C={c} f32",
        ms=cuda_ms(lambda: banded.scatter_add(idx_l0, vals, plan_l0,
                                              params_l0, N_POINTS)),
        plain_ms=cuda_ms(lambda: banded.scatter_add_plain(
            idx_l0, vals, plan_l0, params_l0, N_POINTS)),
        library_ms=cuda_ms(lambda: acc.index_add_(0, flat_idx, flat_vals)),
        bound=bound(n * k * 4 + n * k * c * f32 + N_POINTS * c * f32,
                    n * k * c))

    inputs = cost_attention_inputs(frames, dev)
    out["cost_attention"] = kernel_cost_attention(*inputs)
    out["attention"] = kernel_attention(inputs[0], inputs[1])
    for name, r in out.items():
        say("kernels", f"{name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}), max_abs_err {r['max_abs_err']:.3g}")
    return out


# the main path's knn_group and knn_idw calls by (N, M, k): its layers
SPLIT_LAYERS = {
    "knn_group": {(2048, 8192, 16): "sa1", (512, 2048, 16): "sa2",
                  (2048, 512, 16): "su1", (8192, 2048, 16): "su0",
                  (2048, 2048, 16): "flow1_r", (8192, 8192, 16): "flow0_r"},
    "knn_idw": {(8192, 2048, 7): "L0 upsample_multi",
                (8192, 2048, 3): "L0 upsample_flow",
                (8192, 8192, 7): "L0 point_warping",
                (2048, 512, 5): "L1 upsample_multi",
                (2048, 512, 3): "L1 upsample_flow",
                (2048, 2048, 7): "L1 point_warping"},
}


def split_build(split: int):
    """A context in which knn_group and knn_idw launch with S = split lanes
    per query (a measurement build of band_knn.cu); 0: the shipped
    library, whose S depends on the query count."""
    from ssf_slam_tpu_torch.ops import cuda_build

    if split == 0:
        return contextlib.nullcontext()
    return cuda_build.variant(*SPLIT_BUILDS[SPLITS.index(split)])


def main_path_calls(frames, dev) -> dict:
    """{kernel: {shape key: [inputs, calls]}} of knn_group and knn_idw in a
    2-frame bf16 run of the main path (fuse_attention off; the carry's
    tower, then two scans), the inputs of each shape's first call kept."""
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused
    from ssf_slam_tpu_torch.ops import banded

    seen = {name: {} for name in SPLIT_LAYERS}
    wrapped = {name: getattr(banded, name) for name in seen}

    def spy(name):
        def call(query, points, feats, k, plan, params):
            key = (query.shape[0], query.shape[1], points.shape[1], k,
                   feats.shape[-1], str(feats.dtype).split(".")[-1],
                   params[1] * params[2])
            if key not in seen[name]:
                seen[name][key] = [(query.clone(), points.clone(),
                                    feats.clone(), k,
                                    (plan[0].clone(), plan[1]), params), 0]
            seen[name][key][1] += 1
            return wrapped[name](query, points, feats, k, plan, params)
        return call

    model = bf16_model(dev, fuse=False)
    for name in seen:
        setattr(banded, name, spy(name))
    try:
        run_sequence_fused(model, frames[:2], device=dev)
    finally:
        for name, fn in wrapped.items():
            setattr(banded, name, fn)
    torch.cuda.synchronize()
    return seen


def time_split(name: str, args, tag: str, cold: bool = False) -> None:
    """One redesigned kernel at one shape: exact against its plain version
    with the shipped library and with each measurement build of S. Timed
    with cuda_ms (the yardstick of every ms in phase 2; cold too if asked)
    beside the plain version and its bound, and alone (queued_ms) with the
    shipped library and with each S. Prints one [kernels] line."""
    from ssf_slam_tpu_torch.ops import banded

    kernel, plain = getattr(banded, name), getattr(banded, name + "_plain")
    q, p, f, k, plan, params = args
    want = plain(*args)
    by_split = {}
    for split in SPLITS + (0,):
        with split_build(split):
            got = kernel(*args)
            if name == "knn_group":
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      "kernels", f"{name} {tag} S={split}: differs from plain")
            else:
                check(torch.equal(got[1], want[1])
                      and torch.equal(got[2], want[2]), "kernels",
                      f"{name} {tag} S={split}: sqdist/idx differ")
                # float32: the same operations (1e-5 relative as the
                # tests); bf16: one rounding step, as for the level-0
                # record above
                rel = 2.0 ** -8 if f.dtype == torch.bfloat16 else 1e-5
                err = (got[0].float() - want[0].float()).abs()
                check(bool((err <= 1e-6 + rel * want[0].float().abs()).all()),
                      "kernels",
                      f"{name} {tag} S={split}: out differs by {err.max()}")
            by_split[split] = queued_ms(lambda: kernel(*args))
    b, n, _ = q.shape
    m, c = p.shape[1], f.shape[-1]
    alone, wb = by_split.pop(0), params[1] * params[2]
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    bound_ms, bound_by = (group_bound if name == "knn_group" else idw_bound)(
        b, n, m, k, c, f.element_size(), wb)
    cold_note = f", cold {cold_ms(lambda: kernel(*args)):.4f}" if cold else ""
    say("kernels", f"{name} {tag} B={b} {n}<-{m} k={k} C={c} "
        f"{str(f.dtype).split('.')[-1]} wb={wb}: kernel {ms:.4f} ms"
        f"{cold_note}; alone {alone:.4f} ms ("
        + ", ".join(f"S={sp} {t:.4f}" for sp, t in by_split.items())
        + f"), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), share {bound_ms / ms:.3f}")


def phase_shapes(frames, dev) -> None:
    """knn_group and knn_idw (redesigned for this card) at every distinct
    shape of the main path's scan, batch 1; at the level-0 shapes also at
    batch 4 (the training step's) and cold. Each exact against its plain
    version at every split S; times at each S."""
    from ssf_slam_tpu_torch.engine.fused import sequence_box, stack_fused_scans
    from ssf_slam_tpu_torch.ops import neighbors as nb

    for name, shapes in main_path_calls(frames, dev).items():
        for key, (args, calls) in sorted(shapes.items()):
            layer = SPLIT_LAYERS[name].get((key[1], key[2], key[3]), "?")
            time_split(name, args,
                       f"{layer} ({calls} calls in the 2-scan run)")
    # level 0 at batch 1 and 4, warm and cold: frames 2i -> 2i + 1, each
    # sorted under the sequence box as sorted_pair sorts frames 0 and 1
    scans = stack_fused_scans(frames, N_POINTS)
    box = sequence_box(scans["points"], device=dev)
    clouds = [nb.morton_sort(torch.as_tensor(scans["points"][i:i + 1],
                                             device=dev), box=box)[0]
              for i in range(8)]
    gen = torch.Generator(device=dev).manual_seed(2)
    for bsz in (1, 4):
        q = torch.cat(clouds[0:2 * bsz:2])
        p = torch.cat(clouds[1:2 * bsz:2])
        sparse = p[:, ::4].contiguous()
        feats = torch.randn(bsz, N_POINTS, 99, generator=gen, device=dev)
        fields = torch.randn(bsz, sparse.shape[1], 132, generator=gen,
                             device=dev).to(torch.bfloat16)
        params = nb.band_params(N_POINTS, N_POINTS, 16)
        plan = nb.make_plan(q, p, params, 64.0, box)
        time_split("knn_group", (q, p, feats, 16, plan, params),
                   "flow0_r level 0", cold=True)
        params = nb.band_params(N_POINTS, sparse.shape[1], 7)
        plan = nb.make_plan(q, sparse, params, 64.0, box)
        time_split("knn_idw", (q, sparse, fields, 7, plan, params),
                   "upsample_multi level 0", cold=True)


def cost_attention_inputs(frames, dev):
    """(q_feat, k_feat, q_cost, folded weightnet) of the level-0 cost
    volume (flow0_r, 8192 points) on the bf16 path, frame pair (0, 1)."""
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.models import costvolume
    from ssf_slam_tpu_torch.weights import load_tflow

    model = load_tflow(FlowNetConfig(npoint=N_POINTS, joint_seg=True,
                                     dtype="bfloat16",
                                     neighbor_backend="banded",
                                     fuse_attention=True), device=dev)
    seen = []
    fused = costvolume.cost_attention_fused

    def keep(*args):
        seen.append(args)
        return fused(*args)

    pcs = [torch.as_tensor(f["pos1"][None], device=dev) for f in frames[:2]]
    costvolume.cost_attention_fused = keep
    try:
        with torch.inference_mode():
            model(*pcs)
    finally:
        costvolume.cost_attention_fused = fused
    return max(seen, key=lambda a: a[0].shape[1])


def kernel_cost_attention(q, k, qc, wn) -> dict:
    from ssf_slam_tpu_torch.ops import attention

    _, n, kk, c = q.shape
    c2 = wn[2].shape[1]
    got = attention.cost_attention_fused(q, k, qc, wn)
    want = attention.cost_attention_plain(q, k, qc, wn)
    tol = COST_ATTENTION_TOL
    err_cf = (got[0].float() - want[0].float()).abs()
    err_wk = (got[1] - want[1]).abs()
    check(got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32,
          "kernels", "cost_attention output types")
    ref = want[0].float().abs()
    rms = ref.pow(2).mean().sqrt()
    one_step = (err_cf <= tol["cf_abs"] + tol["cf_rel"] * ref).float().mean()
    wk_ok = (err_wk <= tol["wk_abs"]).float().mean()
    steps = (err_cf / (2.0 ** -8 * (ref + rms))).max().item()
    say("kernels", f"cost_attention agreement: cost_fwd equal on "
        f"{(err_cf == 0).float().mean().item():.6f}, within one step on "
        f"{one_step.item():.6f}, at most {steps:.3f} steps of (|value| + "
        f"rms); w_k within {tol['wk_abs']} on {wk_ok.item():.6f}, at most "
        f"{err_wk.max().item():.3g}")
    check(one_step.item() >= tol["share"]
          and bool((err_cf <= tol["cf_all"] * (ref + rms)).all()), "kernels",
          f"cost_attention cost_fwd: {one_step.item():.6f} within one step, "
          f"max error {err_cf.max().item()}")
    check(wk_ok.item() >= tol["share"] and err_wk.max().item()
          <= tol["wk_all"], "kernels",
          f"cost_attention w_k: {wk_ok.item():.6f} within {tol['wk_abs']}, "
          f"max error {err_wk.max().item()}")
    # multiply-adds per point: S, q' and k' (3 K*K*C), the weightnet on
    # 2K rows (C*C + C*C2 + C2 each) and the aggregation (K*C); x2 FLOP
    flops = 2 * n * (3 * kk * kk * c + 2 * kk * (c * c + c * c2 + c2)
                     + kk * c)
    nbytes = (3 * n * kk * c * 2 + sum(t.numel() for t in wn) * 4
              + n * c * 2 + n * kk * 4)
    return dict(
        max_abs_err=max(err_cf.max().item(), err_wk.max().item()),
        shape=f"[{n},{kk},{c}] C2={c2} bf16",
        ms=cuda_ms(lambda: attention.cost_attention_fused(q, k, qc, wn)),
        plain_ms=cuda_ms(lambda: attention.cost_attention_plain(q, k, qc,
                                                                wn)),
        # no single PyTorch call computes the chain (attention, an MLP and
        # a weighted reduction)
        library_ms=None,
        bound=bound(nbytes, flops, PEAK_BF16))


def kernel_attention(q, k) -> dict:
    """The dual-softmax attention alone on the level-0 cost volume's
    q_feat / k_feat (bf16 [1, 8192, 16, 64])."""
    from ssf_slam_tpu_torch.ops import attention

    _, n, kk, c = q.shape
    got = attention.attention_fused(q, k)
    want = attention.attention_plain(q, k)
    tol = ATTENTION_TOL
    shares, worst = [], 0.0
    for g, w in zip(got, want):
        check(g.dtype == w.dtype == q.dtype, "kernels", "attention types")
        err, ref = (g.float() - w.float()).abs(), w.float().abs()
        rms = ref.pow(2).mean().sqrt()
        shares.append((err <= 1e-6 + tol["step"] * ref).float().mean().item())
        worst = max(worst, (err / (tol["step"] * (ref + rms))).max().item())
    say("kernels", f"attention agreement: within one bf16 step on "
        f"{min(shares):.6f}, at most {worst:.3f} steps of (|value| + rms)")
    check(min(shares) >= tol["share"] and worst <= tol["all_steps"],
          "kernels", f"attention: {min(shares):.6f} within one step, "
          f"{worst:.3f} steps at most")
    max_err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
    # S, q' and k': 3 K*K*C multiply-adds per point in float32 on CUDA
    # cores; two bf16 inputs read and two outputs written
    return dict(
        max_abs_err=max_err, shape=f"[{n},{kk},{c}] bf16",
        ms=cuda_ms(lambda: attention.attention_fused(q, k)),
        plain_ms=cuda_ms(lambda: attention.attention_plain(q, k)),
        # no one call computes the dual-softmax product
        library_ms=None,
        bound=bound(4 * n * kk * c * 2, 2 * n * 3 * kk * kk * c))


# ---------------------------------------------------------------------------
# phases 3 to 5: the whole step
# ---------------------------------------------------------------------------


def _rot_angle(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Angle (rad) of the rotation between [..., 4] xyzw quaternions, in
    float64 via atan2 (arccos of a dot product loses precision near 0)."""
    q1, q2 = np.asarray(q1, np.float64), np.asarray(q2, np.float64)
    v1, w1, v2, w2 = q1[..., :3], q1[..., 3:], q2[..., :3], q2[..., 3:]
    # vector part and scalar of conj(q1) * q2
    v = w1 * v2 - w2 * v1 - np.cross(v1, v2)
    w = np.sum(q1 * q2, axis=-1)
    return 2.0 * np.arctan2(np.linalg.norm(v, axis=-1), np.abs(w))


def phase_f32(frames, dev, n: int = N_FIXTURE_FRAMES) -> None:
    """The first n fixture frames under the fixtures' Morton box (that of
    their 8 frames), fuse_attention off, then frame pair (0, 1) with it on.
    """
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.engine.fused import (
        run_sequence_fused,
        sequence_box,
        stack_fused_scans,
    )
    from ssf_slam_tpu_torch.weights import load_tflow

    ref = {}
    for path in (FIXTURE, SLAM_FIXTURE):
        with np.load(path) as z:
            ref.update({key: z[key] for key in z.files})
    pts = stack_fused_scans(frames[:N_FIXTURE_FRAMES], N_POINTS)["points"]
    box = sequence_box(pts, device=dev)
    check(np.array_equal(box[0].cpu().numpy(), ref["box_origin"])
          and np.array_equal(box[1].cpu().numpy(), ref["box_scale"]),
          "f32", "the fixture's Morton box differs")
    net = dict(npoint=N_POINTS, joint_seg=True, neighbor_backend="banded")
    model = load_tflow(FlowNetConfig(**net), device=dev)
    got = run_sequence_fused(model, frames[:n], device=dev, box=box)
    dt = np.abs(got["rel_t"] - ref["rel_t"][:n]).max()
    dr = _rot_angle(got["rel_q"], ref["rel_q"][:n]).max()
    dpt = np.abs(got["pose_t"] - ref["pose_t"][:n]).max()
    dpr = _rot_angle(got["pose_q"], ref["pose_q"][:n]).max()
    flow, rf = got["flow"][1], ref["flow01"]
    epd = float(np.linalg.norm(flow[:, :3] - rf[:, :3], axis=-1).mean())
    seg = float(((flow[:, 3] < 0) == (rf[:, 3] < 0)).mean())
    say("f32", f"{n} frames vs JAX fixtures: max |d rel_t| {dt:.3g} m, "
        f"rotation {dr:.3g} rad; max |d pose_t| {dpt:.3g} m, pose rotation "
        f"{dpr:.3g} rad; keyframes {got['is_keyframe'].astype(int).tolist()}"
        f"; frame-1 flow mean EPD {epd:.3g} m, seg verdict agreement "
        f"{seg:.6f}")
    for key in ("rel_t", "pose_t", "pose_q", "flow"):
        check(np.isfinite(got[key]).all(), "f32", f"non-finite {key}")
    check(dt <= 1e-2, "f32", f"rel_t differs by {dt} m")
    check(dr <= 1e-3, "f32", f"rotation differs by {dr} rad")
    check(dpt <= 1e-2, "f32", f"pose_t differs by {dpt} m")
    check(dpr <= 1e-3, "f32", f"pose rotation differs by {dpr} rad")
    for key in ("is_keyframe", "n_features"):
        check(np.array_equal(got[key], ref[key][:n]), "f32",
              f"{key} {got[key].tolist()} != {ref[key][:n].tolist()}")
    check(epd <= 1e-2, "f32", f"flow mean EPD {epd} m")

    from ssf_slam_tpu_torch.ops import attention

    fused = load_tflow(FlowNetConfig(**net, fuse_attention=True), device=dev)
    pcs = torch.as_tensor(pts[:2], device=dev)
    before = attention.LAUNCHES["cost_attention"]
    with torch.inference_mode():
        flows, _ = fused.head(fused.tower(pcs[0][None], box),
                              fused.tower(pcs[1][None], box), box)
    flow = flows[0][0].float().cpu().numpy()
    rf = ref["flow01_fused"]
    epd = float(np.linalg.norm(flow[:, :3] - rf[:, :3], axis=-1).mean())
    say("f32", f"fuse_attention: frame-1 flow mean EPD {epd:.3g} m vs the "
        f"JAX fused flow ({attention.LAUNCHES['cost_attention'] - before} "
        f"cost_attention launches)")
    check(attention.LAUNCHES["cost_attention"] - before == 2, "f32",
          "the f32 fused head did not launch cost_attention twice")
    check(np.isfinite(flow).all() and epd <= 1e-2, "f32",
          f"fused flow mean EPD {epd} m")


def sorted_pair(frames, dev):
    """Bench frames 0 and 1 Morton-sorted under the sequence box, as the
    level-0 cost volume sees them: (pc1, pc2, box)."""
    from ssf_slam_tpu_torch.engine.fused import sequence_box, stack_fused_scans
    from ssf_slam_tpu_torch.ops import neighbors as nb

    scans = stack_fused_scans(frames, N_POINTS)
    box = sequence_box(scans["points"], device=dev)
    pcs = [nb.morton_sort(torch.as_tensor(scans["points"][i:i + 1],
                                          device=dev), box=box)[0]
           for i in (0, 1)]
    return pcs[0], pcs[1], box


def phase_entry(frames, dev) -> dict:
    """The remaining entry points of the neighbour engine and the attention
    module at the level-0 shapes, with gradients: nn_knn, nn_knn_group2
    (the cost volume's twin searches, feats xyz2 || points2) and
    attention_fused (on the level-0 cost volume's q_feat / k_feat)."""
    from ssf_slam_tpu_torch.ops import attention
    from ssf_slam_tpu_torch.ops import neighbors as nb

    pc1, pc2, box = sorted_pair(frames, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    flow = 0.05 * torch.randn(1, N_POINTS, 3, generator=gen, device=dev)
    feats = torch.randn(1, N_POINTS, 99, generator=gen, device=dev)
    feats.requires_grad_()
    q, k = (t.clone().requires_grad_()
            for t in cost_attention_inputs(frames, dev)[:2])
    torch.cuda.synchronize()
    reset_all()
    d, idx = nb.nn_knn(pc1, pc2, 16, "banded", box=box)
    ia, ga, ib, gb, _, _ = nb.nn_knn_group2(pc1 + flow, pc1, pc2, pc2 + flow,
                                            feats, 16, "banded", box=box)
    (ga.sum() + 2.0 * gb.sum()).backward()
    qa, ka = attention.attention_fused(q, k)
    (qa.float().sum() + 2.0 * ka.float().sum()).backward()
    torch.cuda.synchronize()
    launches = read_all()
    for name, t in (("knn sqdist", d), ("knn_group2 grouped", ga),
                    ("knn_group2 feats grad", feats.grad),
                    ("attention", qa.float()), ("attention q grad", q.grad),
                    ("attention k grad", k.grad)):
        check(bool(torch.isfinite(t).all()), "entry", f"non-finite {name}")
    # each grouped row is one feats row: its gradient counts how many
    # times (weights 1 and 2) the row was picked
    picks = torch.zeros(N_POINTS, device=dev)
    picks.index_add_(0, ia.reshape(-1).long(), torch.ones(ia.numel(),
                                                           device=dev))
    picks.index_add_(0, ib.reshape(-1).long(),
                     torch.full((ib.numel(),), 2.0, device=dev))
    check(torch.equal(feats.grad[0], picks[:, None].expand(-1, 99)),
          "entry", "nn_knn_group2's gradient is not the pick count")
    say("entry", f"nn_knn, nn_knn_group2 and attention_fused with their "
        f"gradients: launches {launches}")
    for name, want in PER_ENTRY.items():
        check(launches[name] == want, "entry",
              f"{name} launched {launches[name]} times, expected {want}")
    return launches


def reset_all() -> None:
    from ssf_slam_tpu_torch.ops import attention, banded

    banded.reset_launches()
    attention.reset_launches()


def read_all() -> dict:
    from ssf_slam_tpu_torch.ops import attention, banded

    return {**banded.LAUNCHES, **attention.LAUNCHES}


def bf16_model(dev, fuse: bool, weights: str | None = None):
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.weights import DEFAULT_NPZ, load_tflow

    return load_tflow(FlowNetConfig(npoint=N_POINTS, joint_seg=True,
                                    dtype="bfloat16",
                                    neighbor_backend="banded",
                                    fuse_attention=fuse),
                      path=weights or DEFAULT_NPZ, device=dev)


def phase_main(frames, dev, fuse: bool,
               weights: str | None = None) -> tuple[dict, dict]:
    """The whole step over the 32 bench frames (the committed weights, or
    the npz ``weights``); the counters are reset just before the run and
    read just after it."""
    from ssf_slam_tpu_torch.engine.evaluation import ate_rmse
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused

    phase = "main-fused" if fuse else "main"
    model = bf16_model(dev, fuse, weights)
    run_sequence_fused(model, frames[:2], device=dev)  # warm-up
    torch.cuda.synchronize()
    reset_all()
    t0 = time.perf_counter()
    got = run_sequence_fused(model, frames, device=dev)  # ends on the host
    dt = time.perf_counter() - t0
    launches = read_all()
    gt = np.stack([f["pose1"][1] for f in frames])
    ate, ate_odom = ate_rmse(got["pose_t"], gt), ate_rmse(got["odom_t"], gt)
    sps = len(frames) / dt
    n_kf = int(got["is_keyframe"].sum())
    say(phase, f"{len(frames)} frames x {N_POINTS} points: {sps:.2f} scans/s "
        f"({dt * 1e3 / len(frames):.2f} ms/scan, host clock), ATE pose_t "
        f"{ate:.4f} m, odom_t {ate_odom:.4f} m, {n_kf} keyframes, "
        f"n_dyn_over max {int(got['n_dyn_over'].max())}, launches {launches}")
    for key in ("pose_q", "pose_t", "rel_q", "rel_t", "odom_q", "odom_t",
                "flow"):
        check(np.isfinite(got[key]).all(), phase, f"non-finite {key}")
    check(got["flow"].shape == (len(frames), N_POINTS, 4), phase,
          f"flow shape {got['flow'].shape}")
    check(bool(got["is_keyframe"][0]) and n_kf >= 2, phase,
          f"keyframes {got['is_keyframe'].tolist()}")
    for name in PER_SCAN:
        want = PER_SCAN[name] * len(frames) + PER_TOWER[name]
        check(launches[name] == want, phase,
              f"{name} launched {launches[name]} times, expected {want}")
    want = PER_SCAN_FUSED["cost_attention"] * len(frames) if fuse else 0
    check(launches["cost_attention"] == want, phase,
          f"cost_attention launched {launches['cost_attention']} times, "
          f"expected {want}")
    check(ate < 0.5, phase, f"ATE {ate} m")
    return launches, dict(scans_per_s=sps, ate_m=ate, ate_odom_m=ate_odom,
                          keyframes=n_kf)


def phase_profile(frames, dev, host_ms_per_scan: float, out_dir: str,
                  fuse: bool, n: int = 8) -> None:
    """Device time by kernel over n bf16 scans (torch.profiler), written to
    out_dir/profile_<name>.txt; the device busy share is the profiled device
    time per scan over the unprofiled host time per scan (the median of the
    runs in turns). Then the host syncs of n scans
    (torch.cuda.set_sync_debug_mode), counted by the port's source lines
    that reach them."""
    import collections
    import traceback
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import ssf_slam_tpu_torch
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused

    name = "bf16_fused" if fuse else "bf16"
    model = bf16_model(dev, fuse)
    run_sequence_fused(model, frames[:2], device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_sequence_fused(model, frames[:n], device=dev)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device-side events only: the aten ops that launched them carry
        # the same time again
        if e.device_type != DeviceType.CUDA:
            continue
        t = e.self_device_time_total
        if t > 0:
            rows.append((t / 1e3 / n, e.count / n, e.key))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write("device ms/scan  launches/scan  kernel\n")
        for t, c, key in rows:
            f.write(f"{t:14.4f}  {c:13.1f}  {key}\n")
    # each sync, by the innermost two frames of the port that led to it
    sites = collections.Counter()
    pkg = os.path.dirname(ssf_slam_tpu_torch.__file__)

    def note(message, *args, **kwargs):
        if "synchroniz" in str(message):
            mine = [f for f in traceback.extract_stack()
                    if f.filename.startswith(pkg)][-2:]
            sites[" <- ".join(f"{os.path.relpath(f.filename, pkg)}:{f.lineno}"
                              for f in reversed(mine))] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run_sequence_fused(model, frames[:n], device=dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    say("profile", f"{name}: device time {dev_ms:.3f} ms/scan over {n} "
        f"scans, {sum(r[1] for r in rows):.0f} launches/scan, busy share "
        f"{dev_ms / host_ms_per_scan:.3f} of {host_ms_per_scan:.2f} ms/scan;"
        f" {sum(sites.values())} host syncs in {n} scans (the output copies "
        f"included)")
    for t, c, key in rows[:15]:
        say("profile", f"{t:9.4f} ms/scan {c:7.1f}/scan  {key[:90]}")
    for site, count in sites.most_common():
        say("profile", f"{count:4d} syncs  {site}")


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------


# each cost volume's weightnet output bias shifts every logit of a
# per-segment softmax alike: its gradient is zero in exact arithmetic, and
# what is computed is rounding noise (about 1e-8 of the largest leaf norm)
ZERO_GRAD = re.compile(r"params/flow\d_r/Dense_2/bias$")


def _leaf_errors(got: dict, want: dict) -> dict:
    """{leaf: |got - want| / (|want| + 1e-6 s)} of flat float arrays (of
    norms, for scalars), s the largest leaf norm (the 1e-6 s keeps dead
    leaves, exactly zero, from dividing by zero); a zero-gradient leaf
    (ZERO_GRAD) instead reports the larger of its two norms over 1e-3 s,
    so that it passes a 1e-3 check while it is noise below 1e-6 s."""
    scale = max(float(np.linalg.norm(w)) for w in want.values())
    out = {}
    for k, w in want.items():
        if ZERO_GRAD.search(k):
            out[k] = max(float(np.linalg.norm(got[k])),
                         float(np.linalg.norm(w))) / (1e-3 * scale)
        else:
            out[k] = float(np.linalg.norm(got[k] - w)) / (
                float(np.linalg.norm(w)) + 1e-6 * scale)
    return out


def _grads(model, batch, loss_cfg, retain=False):
    """(loss, flat Flax gradients, autograd inputs) of one train-mode
    forward and backward."""
    from ssf_slam_tpu_torch.train.trainer import forward_loss
    from ssf_slam_tpu_torch.weights import to_flax

    model.train()
    params = dict(model.named_parameters())
    loss, _ = forward_loss(model, batch, loss_cfg)
    grads = torch.autograd.grad(loss, list(params.values()),
                                retain_graph=retain)
    return loss, to_flax(model, dict(zip(params, grads))), (loss, params)


def phase_train(dev, profile_dir: str | None = None) -> dict:
    """The training path (module docstring, phase 7). Returns the train
    loop's launch counts. With ``profile_dir``, also the device time of two
    train steps by kernel (``profile_train``)."""
    from ssf_slam_tpu_torch.config import (FlowNetConfig, LossConfig,
                                           TrainConfig)
    from ssf_slam_tpu_torch.data.carla import compute_label_weights
    from ssf_slam_tpu_torch.ops import banded
    from ssf_slam_tpu_torch.ops import neighbors as nb
    from ssf_slam_tpu_torch.train.harness import batcher
    from ssf_slam_tpu_torch.train.train_ssf import build_corpus
    from ssf_slam_tpu_torch.train.trainer import (
        create_train_state,
        forward_loss,
        make_eval_step,
        make_train_step,
        to_device,
    )
    from ssf_slam_tpu_torch.weights import load_tflow, to_flax

    t0 = time.perf_counter()
    train, held_out = build_corpus(2, 4, eval_frames=TRAIN_BATCH)
    lw = compute_label_weights(train)
    loss_cfg = LossConfig(seg_class_weights=(float(lw[0]), float(lw[1])))
    say("train", f"corpus {len(train)} pairs + {len(held_out)} held out in "
        f"{time.perf_counter() - t0:.1f} s; label weights {lw.tolist()}; "
        f"lr {TRAIN_LR}")
    net = dict(npoint=N_POINTS, joint_seg=True, neighbor_backend="banded")
    cfg = FlowNetConfig(**net, dtype="bfloat16")
    tcfg = TrainConfig(lr=TRAIN_LR, batch_size=TRAIN_BATCH)
    batches = [to_device(b, dev) for b in
               batcher(train, TRAIN_BATCH, [tcfg.seed])()]
    model = load_tflow(cfg, device=dev)
    state, tx = create_train_state(model, tcfg)

    # one step by hand: the forward's and the backward's launches
    reset_all()
    nb.SEGMENT_SUMS["backward"] = 0
    model.train()
    params = state.params
    loss, _ = forward_loss(model, batches[0], loss_cfg)
    torch.cuda.synchronize()
    fwd = read_all()
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    bwd = {k: v - fwd[k] for k, v in read_all().items()}
    tx.update(dict(zip(params, grads)), state.opt_state, params)
    state.step += 1
    say("train", f"launches of one step: forward "
        f"{ {k: v for k, v in fwd.items() if v} }, backward "
        f"{ {k: v for k, v in bwd.items() if v} } "
        f"({nb.SEGMENT_SUMS['backward']} segment sums asked)")
    for name, want in PER_STEP_FWD.items():
        check(fwd[name] == want, "train",
              f"forward: {name} launched {fwd[name]} times, expected {want}")
    check(bwd["scatter_add"] == PER_STEP_BWD["scatter_add"]
          == nb.SEGMENT_SUMS["backward"], "train",
          f"backward: scatter_add launched {bwd['scatter_add']} times, "
          f"segment sums {nb.SEGMENT_SUMS['backward']}, expected "
          f"{PER_STEP_BWD['scatter_add']}")
    check(sum(bwd.values()) == bwd["scatter_add"], "train",
          f"the backward launched other kernels: {bwd}")

    # the train loop: the main path, counters reset just before it
    step = make_train_step(model, tx, tcfg, loss_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all()
    t0 = time.perf_counter()
    losses = []
    for i in range(TRAIN_STEPS):
        state, m = step(state, batches[i % len(batches)])
        losses.append(m["loss"])
    losses = [float(x) for x in losses]  # ends on the host
    dt = time.perf_counter() - t0
    launches = read_all()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    evaluate = make_eval_step(model)
    ev = evaluate(state, to_device(next(batcher(held_out, TRAIN_BATCH,
                                                [999])()), dev))
    ev = {k: float(v) for k, v in ev.items()}
    say("train", f"{TRAIN_STEPS} steps x {TRAIN_BATCH} x {N_POINTS} points "
        f"bf16: losses {[round(x, 4) for x in losses]}, "
        f"{TRAIN_STEPS / dt:.3f} steps/s, {TRAIN_STEPS * TRAIN_BATCH / dt:.2f}"
        f" samples/s (host clock), peak memory {peak:.2f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} }; eval EPE "
        f"{ev['epe3d']:.4f} m, mIoU {ev['miou']:.4f}")
    if profile_dir is not None:
        profile_train(step, state, batches, profile_dir, dt / TRAIN_STEPS)
    check(all(np.isfinite(losses)), "train", f"losses {losses}")
    check(np.isfinite(ev["epe3d"]) and np.isfinite(ev["miou"]), "train",
          f"eval {ev}")
    for name in (*PER_STEP_FWD, *PER_STEP_BWD):
        want = TRAIN_STEPS * {**PER_STEP_FWD, **PER_STEP_BWD}[name]
        check(launches[name] == want, "train",
              f"{name} launched {launches[name]} times, expected {want}")

    # the loss on one fixed batch falls
    model = load_tflow(cfg, device=dev)
    state, tx = create_train_state(model, tcfg)
    step = make_train_step(model, tx, tcfg, loss_cfg)
    fixed = [float(step(state, batches[0])[1]["loss"])
             for _ in range(DESCENT_STEPS + 1)]
    say("train", f"fixed batch, lr {TRAIN_LR}: loss {fixed[0]:.4f} -> "
        f"{fixed[-1]:.4f} after {DESCENT_STEPS} steps "
        f"({[round(x, 4) for x in fixed]})")
    check(fixed[-1] < fixed[0], "train",
          f"the fixed-batch loss did not fall: {fixed}")

    # first-step f32 gradients: the backward's scatter_add against its
    # plain version on the same graph, then every kernel against its plain
    # version on the same batch
    model = load_tflow(FlowNetConfig(**net), device=dev)
    loss, g_kernel, (loss_t, params) = _grads(model, batches[0], loss_cfg,
                                              retain=True)
    kernel_add = banded.scatter_add
    banded.scatter_add = banded.scatter_add_plain
    try:
        g_plain_bwd = to_flax(model, dict(zip(params, torch.autograd.grad(
            loss_t, list(params.values())))))
    finally:
        banded.scatter_add = kernel_add
    err = _leaf_errors(g_kernel, g_plain_bwd)
    worst = max(err, key=err.get)
    say("train", f"f32 first-step gradients, backward kernel vs plain on "
        f"one graph: worst leaf {worst} at {err[worst]:.2e} of its norm")
    check(err[worst] <= 1e-3, "train",
          f"gradient leaf {worst} differs by {err[worst]:.2e} of its norm")
    names = ("knn_group", "knn_idw", "regroup", "scatter_softmax_sum",
             "scatter_add")
    kernels = {n: getattr(banded, n) for n in names}
    for n in names:
        setattr(banded, n, getattr(banded, f"{n}_plain"))
    try:
        loss_p, g_plain, _ = _grads(model, batches[0], loss_cfg)
    finally:
        for n, fn in kernels.items():
            setattr(banded, n, fn)
    err = _leaf_errors(g_kernel, g_plain)
    order = sorted(err, key=err.get, reverse=True)
    say("train", f"f32 first-step gradients, all kernels vs all plain "
        f"versions: loss {loss.item():.6f} vs {loss_p.item():.6f}; "
        f"{sum(e > 1e-3 for e in err.values())} of {len(err)} leaves beyond"
        f" 1e-3 of their norm; worst " + ", ".join(
            f"{k} {err[k]:.2e}" for k in order[:4]))
    check(err[order[0]] <= 1e-3, "train", f"gradient leaf {order[0]} "
          f"differs by {err[order[0]]:.2e} of its norm between the kernels"
          f" and the plain versions")
    phase_train_parity(dev, loss_cfg)
    return launches


def profile_train(step, state, batches, out_dir: str,
                  host_s_per_step: float, n: int = 2) -> None:
    """Device time by kernel over n train steps (torch.profiler), written
    to out_dir/profile_train.txt; the busy share is the device time per
    step over the unprofiled host time per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3 / n, e.count / n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    dev_ms = sum(r[0] for r in rows)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_train.txt"), "w") as f:
        f.write("device ms/step  launches/step  kernel\n")
        for t, c, key in rows:
            f.write(f"{t:14.4f}  {c:13.1f}  {key}\n")
    say("profile", f"train: device time {dev_ms:.2f} ms/step over {n} steps,"
        f" {sum(r[1] for r in rows):.0f} launches/step, busy share "
        f"{dev_ms / (host_s_per_step * 1e3):.3f} of "
        f"{host_s_per_step * 1e3:.1f} ms/step")
    for t, c, key in rows[:15]:
        say("profile", f"{t:9.3f} ms/step {c:8.1f}/step  {key[:90]}")


def phase_train_parity(dev, loss_cfg) -> None:
    """The f32 train step on the fixture's batch against JAX's."""
    import dataclasses

    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.train.trainer import to_device
    from ssf_slam_tpu_torch.weights import load_tflow, to_flax

    with np.load(TRAIN_FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    frames = bench_frames(2)
    batch = to_device({k: np.stack([f[k] for f in frames]) for k in (
        "pos1", "pos2", "gt", "mask1", "s_fg_mask")}, dev)
    lw = ref["label_weights"]
    loss_cfg = dataclasses.replace(
        loss_cfg, seg_class_weights=(float(lw[0]), float(lw[1])))
    model = load_tflow(FlowNetConfig(npoint=N_POINTS, joint_seg=True,
                                     neighbor_backend="banded"), device=dev)
    loss, grads, _ = _grads(model, batch, loss_cfg)
    stats = {k: v for k, v in to_flax(model).items()
             if k.startswith("batch_stats/")}
    d_loss = abs(loss.item() - float(ref["loss"])) / abs(float(ref["loss"]))
    want = {k: np.float64(ref[f"grad_norm/{k}"]) for k in grads}
    norm_err = _leaf_errors({k: np.linalg.norm(g) for k, g in
                             grads.items()}, want)
    stat_err = {k: float(np.max(np.abs(v - ref[k])
                                / (np.abs(ref[k]) + 1e-6)))
                for k, v in stats.items()}
    wn, ws = (max(e, key=e.get) for e in (norm_err, stat_err))
    say("train", f"f32 step vs the JAX fixture: loss {loss.item():.6f} vs "
        f"{float(ref['loss']):.6f} ({d_loss:.2e} relative); gradient norms: "
        f"{sum(e > 1e-3 for e in norm_err.values())} of {len(norm_err)} "
        f"beyond 1e-3, worst {wn} {norm_err[wn]:.2e}; batch statistics: "
        f"{sum(e > 1e-4 for e in stat_err.values())} of {len(stat_err)} "
        f"beyond 1e-4, worst {ws} {stat_err[ws]:.2e}")
    check(d_loss <= 1e-4, "train", f"loss differs by {d_loss:.2e}")
    check(norm_err[wn] <= 1e-3, "train",
          f"gradient norm of {wn} differs by {norm_err[wn]:.2e}")
    check(stat_err[ws] <= 1e-4, "train",
          f"batch statistics {ws} differ by {stat_err[ws]:.2e}")


def main() -> int:
    args = sys.argv[1:]
    profile_dir = serve = None
    if args:
        if len(args) != 2 or args[0] not in ("--profile", "--serve"):
            print("usage: python3 chip_smoke.py [--profile DIR | --serve NPZ]",
                  file=sys.stderr)
            return 2
        profile_dir, serve = (args[1], None) if args[0] == "--profile" \
            else (None, args[1])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from ssf_slam_tpu_torch.ops.precision import set_geom_precision

    set_geom_precision()
    dev = torch.device("cuda")
    if serve is not None:
        # a checkpoint of the port's trainer through the serving path
        phase_build()
        phase_main(bench_frames(), dev, fuse=False, weights=serve)
        return 0
    phase_build()
    frames = bench_frames()
    records = phase_kernels(frames, dev)
    phase_shapes(frames, dev)
    phase_f32(frames, dev)
    launches, e2e = phase_main(frames, dev, fuse=False)
    launches_fused, e2e_fused = phase_main(frames, dev, fuse=True)
    if profile_dir is not None:
        # the two settings in turns, each order as often as the other
        # (off, on | on, off | off, on | on, off): the host clock's spread
        # beside their difference
        runs = {False: [e2e["scans_per_s"]], True: [e2e_fused["scans_per_s"]]}
        for fuse in (True, False, False, True, True, False):
            runs[fuse].append(phase_main(frames, dev, fuse)[1]["scans_per_s"])
        med = {fuse: float(np.median(s)) for fuse, s in runs.items()}
        say("turns", "scans/s, fuse_attention off: " + ", ".join(
            f"{s:.2f}" for s in runs[False]) + f" (median {med[False]:.2f}); "
            "on: " + ", ".join(f"{s:.2f}" for s in runs[True])
            + f" (median {med[True]:.2f})")
        for fuse in (False, True):
            phase_profile(frames, dev, 1e3 / med[fuse], profile_dir,
                          fuse=fuse)
    launches_entry = phase_entry(frames, dev)
    launches_train = phase_train(dev, profile_dir)
    kernels = []
    for name, r in records.items():
        src, replaces = KERNELS[name]
        # each kernel's count from the path that runs it: the serving step
        # (phase 4, or 5 for cost_attention), the entry points (phase 6) or
        # the training loop (phase 7)
        if name in PER_SCAN_FUSED:
            n_launch = launches_fused[name]
        elif name in PER_STEP_BWD:
            n_launch = launches_train[name]
        elif name in PER_ENTRY:
            n_launch = launches_entry[name]
        else:
            n_launch = launches[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=n_launch, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
