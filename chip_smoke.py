"""Chip smoke test of the PyTorch + CUDA port (``ssf_slam_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package. Phases, each
printing its own line and failing loudly:

1. build: compile every CUDA source of the port with nvcc (all at once,
   beside the measurement builds: band_knn.cu with the split S fixed at 8,
   16 and 32, cost_attention.cu without its recheck, band_scatter.cu with the
   scatters' value loads fixed at 1 and 4 elements, where the shipped
   library takes 2), check in nvcc's -Xptxas -v report (kept beside each
   library) that every kernel of the kNN and the attention libraries, and
   every bf16 cost_attention, scatter and regroup instance, has a 0-byte
   stack frame and no spills (printing the shipped libraries' lines) and
   print the card's name and power limit;
2. kernels: each of the nine kernels at its largest main-path shape, on
   Morton-sorted clouds of the bench sequence (the cost attention on the
   level-0 cost volume's own inputs, with the folded weightnet of the
   committed flow0_r), held against its plain PyTorch version on the card
   (exact: idx, sqdist, grouped, regroup; knn_idw's bf16 output to one bf16
   rounding step, 2^-8 relative + 1e-6 absolute; scatter_softmax_sum to
   1e-5 relative + 1e-5 absolute for the atomics' run-to-run order;
   cost_attention as stated and justified at COST_ATTENTION_TOL; knn and
   knn_group2 exact; scatter_add as the scatter; attention as stated at
   ATTENTION_TOL, printing the body that ran and its agreement, and again
   at batch 4 (frame pairs 0-3) and in float32 (within 1e-5), each timed
   alone), and timed with CUDA
   events beside the plain version, one PyTorch library call where one
   computes the same function, and the bound of the card. Then
   knn_group and knn_idw, redesigned for the card, at every distinct shape
   their wrappers receive in a 2-frame run of the ssfc main path (SSF's
   calls and the SegNet's two knn_group shapes; batch 1 and batch 8, the
   batched serving path's, from eight distinct frame pairs' runs), and
   at the level-0 shapes at batch 1, 4 and 8, warm and with the L2 flushed
   before each launch: exact against the plain version (knn_idw's output as
   above; float32 to 1e-5 relative) with the split S (lanes per query) the
   shipped library picks and with each measurement build's; timed as above
   and, to compare the splits, alone (queued behind a device-side sleep, so
   that no host work is timed) with each; knn and knn_group2 (f32 and
   bf16 feats) the same way at the level-0 shape, batch 1, 4 and 8, exact,
   with knn's time beside knn_group's. cost_attention at both launches
   of a scan (8192 and 2048 points) and scatter_add at the level-0 shape,
   batch 1, 4 and 8, float32 and bf16 values, are timed alone too, the latter
   with its device-memory atomics against one an entry and channel;
   scatter_softmax_sum alone with each value-load width build; regroup
   (exact) and scatter_softmax_sum (1e-5 + 1e-5 |want| beyond the rounding
   bound of two float32 sums in two orders, softmax_agreement) at every
   distinct shape of the 2-frame run, at batch 1, 4 and 8, timed beside
   their plain versions and bounds;
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
   with two cost_attention launches per scan, and cost_attention's time a
   scan alone (phase 2) beside its bound;
6. entry: the neighbour engine's and the attention module's remaining
   entry points (nn_knn, nn_knn_group2 and attention_fused, the last two
   with their gradients) at the level-0 shapes, counters reset just before
   and read just after: one launch each of knn, knn_group2 and attention,
   two of scatter_add;
6b. loop: tests/test_torch_slam.py's 72-frame out-and-back circuit (1024
   points, provided flow with an odometry drift) through the SSF
   run_sequence on the card, so that loop closure, ICP and the pose graph
   run there: n_loops equal to the JAX fixture's
   (tests/fixtures/torch_port/ssf_slam_small_ref.npz, loop/*) and > 0,
   is_keyframe equal, pose_t and odom_t within LOOP_TOL (1e-3 m); then the
   keyframe buffer past max_keyframes (tests/test_torch_mapping.py's
   overflow case: 5 slots, 21 keyframes, 4 loop closures past the buffer)
   through mapping_step on the card against the JAX run committed in
   tests/fixtures/torch_port/mapping_overflow_ref.npz: keyframe flags,
   n_kf and n_loops equal at every step, the poses within OVERFLOW_TOL
   (1e-4, the CPU test's tolerance), the loop slots equal;
7. train: the training path at full width (8192 points, joint seg, bf16,
   banded, batch 4), warm-started from the committed weights with a fresh
   optimizer, on a corpus of 2 worlds x 4 frames with label weights: the
   forward's and the backward's launches of one step; a few steps of the
   train loop (counters reset just before and read just after; steps/s,
   samples/s, peak memory), one eval pass (EPE, mIoU); the loss on one
   fixed batch falling over 8 steps at TRAIN_LR; the first step's f32
   gradients with the backward's scatter_add against its plain version;
   scatter_add at every shape of the bf16 and the f32 step's segment sums,
   against its plain version and timed alone beside its bound (the bf16
   step's also with each value-load width build);
   and the f32 train step against the JAX fixture
   tests/fixtures/torch_port/ssf_train_ref.npz (loss 1e-4 relative, each
   leaf's gradient norm 1e-3 relative, the new batch statistics 1e-4);
8. variants: the pipeline variants besides SSF and ``geom_refine``. (a) f32
   parity: the committed weights over the first 8 bench frames against
   the JAX fixture tests/fixtures/torch_port/variants_ref.npz, phase 3's
   tolerances (rel_t and pose_t within 1e-2 m, rotations within 1e-3 rad,
   is_keyframe and n_features equal), for SF fused, SF fused with
   geom_refine, SSF fused with geom_refine, and SEG, NO_SEG and ONLY_PC
   through run_sequence on the ground-truth flow; (b) the SF main path:
   bf16, the 32 bench frames, tower caching, the whole step with the GMM
   split, counters reset just before and read just after, each equal to
   phase 4's; finite outputs, ATE of pose_t below 0.5 m, scans/s; (c) the
   evo protocol of README.md's round-5 table (the seed-100 sequence, 40
   frames x 8192 points, 4 movers, bf16): seg, onlypc, noseg, sf and ssf
   raw, sf and ssf with geom_refine, each written to a TUM file with the
   port's write_tum and read back, printed as a table of ATE vs the seg
   run, RPE (translation, rotation) vs it, ATE vs the ground truth, the
   ATE vs the ground truth of the committed results_r5/ or
   results_r5_refine/ trajectory and scans/s; every run but onlypc within
   EVO_MARGIN (0.02 m) of its committed trajectory's ATE vs the ground
   truth, onlypc finite (its parity is (a)'s); ssfc and ssfc with
   geom_refine among the runs (the SegNet classifier, bf16, as the JAX CLI
   builds it, with the committed weights);
9. ssfc and the entry points. (a) f32 parity: both nets' committed
   weights over the first 8 bench frames against the JAX fixture
   tests/fixtures/torch_port/ssfc_ref.npz at phase 3's tolerances, and
   frame 1's classifier on the fixture's flow: static masks equal on
   SEG_AGREE (99.9 %) of the points, logits within 1e-3; (b) the ssfc main
   path: bf16, the 32 bench frames, tower caching, the whole step with the
   classifier's mask, counters reset just before and read just after, each
   equal to phase 4's plus the SegNet's PER_SCAN_SEGNET a scan; finite
   outputs, ATE of pose_t below 0.5 m, scans/s beside phase 4's, the
   SegNet's device time and launches a scan (torch.profiler); (f)
   predict_flow_resampled on frame pair (0, 1): how far its members lie
   apart; (d) the command line in
   subprocesses: run --variant ssfc (f32 TFlow) within RUN_TOL (1e-3 m) of
   the same build in process, evaluate --variants noseg,ssfc (its TUM and
   KITTI files and table), run --stream at depth 1 and 2 (its rate and
   latency lines); (e) StreamingRunner in f32 over 8 frames within RUN_TOL
   of run_sequence_fused under the runner's box, a state checkpoint after
   4 of the 8 scans resumed in a fresh runner within RUN_TOL of the
   uninterrupted run, and in bf16 over the 32 frames at depth 1, 2, 2 and
   1 in turns (Hz, completion latency mean and p95, dispatch mean and p95);
10. batched: many sequences on one card and SegNet training. (a) f32, the
   committed weights, B = 2 (the first 8 frames of batch_economics.py's
   sequences 0 and 1, its configuration): each member of
   run_sequences_fused_batched against the same member run alone through
   run_sequence_fused under the shared box, pose_t and odom_t within
   LOOP_TOL (1e-3 m), is_keyframe equal; the no-model
   run_sequences_batched (SEG, ground-truth flow) the same way against
   run_sequence; (b) the batch-economics table in bf16
   (ssf_slam_tpu_torch.parallel.batch_economics: 16 frames, B = 1, 2, 4,
   8 under one box): for each B the aggregate and per-sequence scans/s
   (median and range of the repeats), the kernel launches a scan (each
   counter reset just before a run and read just after it, equal to phase
   4's per-scan counts at every B: the network runs once a scan over the
   batch), the peak memory, each member's ATE of pose_t (below 0.5 m)
   and the card's name and power limit; (c) SegNet training
   (train/train_segnet.py's step: bf16, 8192 points, batch 4, Adam at
   1e-3, flow noise, the exact neighbour backend, so no hand-written
   kernel runs): the loss on one fixed batch falling over SEG_STEPS steps,
   steps/s and peak memory; and the f32 step of the small SegNet against
   tests/fixtures/torch_port/segnet_train_small_ref.npz (loss 1e-4
   relative, each leaf's gradient norm 1e-3 relative);
11. sharded: torch.distributed at world size 1 over NCCL on the card (no
   fallback to another backend). (a) run_sequences_sharded at the serving
   point (SSF, bf16, the committed weights, the first 8 bench frames):
   every serving counter equal to phase 4's per-scan counts (reset just
   before, read just after), its poses within 3 times the larger of
   LOOP_TOL (1e-3 m) and the spread of three bf16 run_sequence_fused runs
   under the same box (the scatters' float32 atomics order differs run to
   run) of each of them; in f32 the same pair within LOOP_TOL;
   run_sequences_sharded_streaming from an ssfb stripe at depth 1 and 2
   (hz_per_seq, latency: the sharded row of scripts/bench_streaming.py)
   against the batch run under the stream's anchored box, in bf16 within
   the same bound, in f32 within LOOP_TOL; one f32 make_sharded_train_step on
   the first two bench pairs against make_train_step (loss 1e-5 relative,
   99.9 % of the parameters within 1e-6 and all within 2.5 lr, Adam's
   sign edge; statistics 1e-4), its forward and backward kernels counted;
   (b) pointsharded_knn_group, banded, 8192 x 8192, k 16, C 99, halo 512
   (scripts/pointshard_chip_smoke.py's case): knn_group launched, recall
   above 0.9 against pointshard_reference, grouped rows exact copies, the
   kernel on the extended target equal to its plain version and the
   sharded result its translation; (c) Town02 code on a generated planar
   map (written to a temporary KITTI .bin, data/town02.py::MAP_BIN pointed
   at it; not Town02): make_frames with 4 vehicles and facades, then
   eval_town02 at 8192 points in bf16 over 6 pairs, finite ATE, EPE3D,
   Acc3DR and moving IoU.

With ``--profile DIR`` it then runs phases 5 and 4 three times more in
turns (so that each setting runs first as often as the other) and prints
their scans/s side by side, traces 8 scans of each main path with
torch.profiler, writes device time by kernel to DIR/profile_<name>.txt,
prints the two settings' device time per scan side by side and counts the
host syncs per scan by the port's source lines; phase 7 then also traces
two train steps (DIR/profile_train.txt). With ``--serve NPZ``
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
# the largest batch of the batched serving path (phase 10 b)
SERVE_BATCH = 8
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
    fn()  # untimed: the allocator's blocks for the outputs beside flush
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


def scatter_bound(b, n, k, c, esize, n_out) -> tuple[float, str]:
    """scatter_add's bound: idx and the values read once, the float32
    output written once; one add per value."""
    return bound(b * (n * k * 4 + n * k * c * esize + n_out * c * 4),
                 b * n * k * c)


def group_bound(b, n, m, k, c, esize, wb) -> tuple[float, str]:
    """knn_group's bound: clouds, feats, sqdist + idx and the grouped rows
    moved once; 8 operations per band candidate."""
    return bound(b * ((n + m) * 3 * 4 + m * c * esize + n * k * (2 * 4)
                      + n * k * c * esize), b * n * wb * 8)


def knn_bound(b, n, m, k, wb) -> tuple[float, str]:
    """knn's bound: clouds read and sqdist + idx written once; 8 operations
    per band candidate (the selection's compares are not counted)."""
    return bound(b * ((n + m) * 3 * 4 + n * k * (2 * 4)), b * n * wb * 8)


def group2_bound(b, n, m, k, c, esize, wb) -> tuple[float, str]:
    """knn_group2's bound: both searches' clouds, the shared feats, both
    sqdist + idx and both grouped tensors moved once; 8 operations per band
    candidate of each search."""
    return bound(b * (2 * (n + m) * 3 * 4 + m * c * esize
                      + 2 * (n * k * (2 * 4) + n * k * c * esize)),
                 b * 2 * n * wb * 8)


def idw_bound(b, n, m, k, c, esize, wb) -> tuple[float, str]:
    """knn_idw's bound: clouds, feats, the [N, C] output and sqdist + idx
    moved once; 8 operations per band candidate, 2 per mixed element."""
    return bound(b * ((n + m) * 3 * 4 + m * c * esize + n * c * esize
                      + n * k * (2 * 4)), b * (n * wb * 8 + n * k * c * 2))


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


# lanes per query that the measurement builds of band_knn.cu fix for
# every kNN kernel (the shipped library picks S by query count)
SPLITS = (8, 16, 32)
SPLIT_BUILDS = tuple(("ssf_band_knn", (f"SSF_KNN_SPLIT={s}",))
                     for s in SPLITS)
# a measurement build of cost_attention.cu without the recheck of the sums
# near a bf16 rounding boundary, to time what the recheck costs
RECHECK_BUILD = ("ssf_cost_attention", ("SSF_CA_NO_RECHECK",))
# measurement builds of band_scatter.cu: the elements of the scatters'
# value loads (VEC, where C and the values' pointer allow vector loads; a
# lane takes max(2, VEC) channels) fixed at 1 and 4 (the shipped library
# takes 2), kept while the scatters' remaining gap is open (ROADMAP.md §2)
SCATTER_VECS = (1, 4)
VEC_BUILDS = tuple(("ssf_band_scatter", (f"SSF_SCATTER_VEC={v}",))
                   for v in SCATTER_VECS)
MEASUREMENT_BUILDS = SPLIT_BUILDS + (RECHECK_BUILD,) + VEC_BUILDS
NO_FRAME = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
# the kernels held to NO_FRAME in each library's report (None: every entry
# of the report), and how many instances each library has: the kNN
# library's two kernels, knn_group_kernel (knn, knn_group, knn_group2) and
# knn_idw_kernel (K 3, 5, 7, 8, 16, 32 x two element types x two kernels,
# and x S 8, 16, 32 in the shipped library), the bf16 cost attention ((KP
# 16 x CP 32, 64, 128) and (KP 32 x CP 128), x C2P 16, 32, 64, 128), the
# scatters (two element types x scatter-add and softmax-sum x VEC 1 and the
# shipped VEC), regroup (units of 16, 8, 4 and 2 bytes) and every kernel of
# the attention library: the tensor-core body (KP 16, 32 x CP 32, 64, 128)
# and the CUDA-core body (float32 and bf16)
FRAME_CHECKS = {"ssf_band_knn": (None, 72),
                "ssf_cost_attention": (("cost_attention_kernel",), 16),
                "ssf_band_scatter": (("scatter_kernel", "regroup_kernel"),
                                     12),
                "ssf_attention": (None, 8)}
# the measurement builds held to NO_FRAME too, and their instance counts
# (one S; VEC = 1 has one scatter instance a type and kind)
CHECKED_BUILDS = {**{b: 24 for b in SPLIT_BUILDS}, VEC_BUILDS[0]: 8,
                  VEC_BUILDS[1]: 12}


def check_frames(label: str, log: str, kernels) -> list[str]:
    """Checks that every entry of the named kernels (None: every entry) in
    an ``nvcc -Xptxas -v`` report has a 0-byte stack frame and no spills;
    returns the entries' lines."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for (\S+)", line)
        if m and (kernels is None or any(k in m.group(1) for k in kernels)):
            frame = lines[i + 1].strip() if i + 1 < len(lines) else ""
            check(frame == NO_FRAME, "build",
                  f"{label}: {m.group(1)}: {frame}")
            regs = re.search(r"Used \d+ registers",
                             lines[i + 2] if i + 2 < len(lines) else "")
            out.append(f"{m.group(1)}: {frame}"
                       + (f"; {regs.group(0)}" if regs else ""))
    return out


def phase_build() -> str:
    from ssf_slam_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all(variants=MEASUREMENT_BUILDS)
    for name, defines in [(n, ()) for n in FRAME_CHECKS] + list(
            CHECKED_BUILDS):
        kernels, count = FRAME_CHECKS[name]
        entries = check_frames(name + "".join(f" -D{d}" for d in defines),
                               cuda_build.ptxas_report(name, defines),
                               kernels)
        what = "kernel" if kernels is None else " / ".join(kernels)
        want = CHECKED_BUILDS[(name, defines)] if defines else count
        check(len(entries) == want, "build", f"{name} {defines}: "
              f"{len(entries)} {what} entries, not {want}")
        if not defines:
            for line in entries:
                say("build", f"{name}: {line}")
        else:
            say("build", f"{name} -D{defines[0]}: {len(entries)} {what} "
                f"entries, each {NO_FRAME}")
    # the build without the recheck is timed only, not held to NO_FRAME
    report = cuda_build.ptxas_report(*RECHECK_BUILD).splitlines()
    for i, line in enumerate(report):
        if "cost_attention_kernelILi16ELi64ELi32E" in line \
                and "Function properties" in line:
            say("build", f"{RECHECK_BUILD[0]} -D{RECHECK_BUILD[1][0]} "
                f"(timed only), the main path's instance <16, 64, 32>: "
                f"{report[i + 1].strip()}; {report[i + 2].strip()}")
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    for name, defines in MEASUREMENT_BUILDS:
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
    from ssf_slam_tpu_torch.ops import attention, banded, cuda_build
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
    vals = vals_ss = randn(1, N_POINTS, k, c, dtype=torch.bfloat16)
    w = randn(1, N_POINTS, k)
    w_shift = (w - w.max()).contiguous()
    got = banded.scatter_softmax_sum(idx_l0, vals, w_shift, plan_l0,
                                     params_l0, N_POINTS)
    want = want_ss = banded.scatter_softmax_sum_plain(
        idx_l0, vals, w_shift, plan_l0, params_l0, N_POINTS)
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
        bound=knn_bound(1, n, m, k, wb))

    # knn_group2: the cost volume's twin searches, query xyz1 + coarse
    # flow and xyz1, targets xyz2 and a warped copy of it, feats
    # xyz2 || points2 (C = 99 f32), under the plan of the first pair
    c = 99
    qb = (pc1 + 0.05 * randn(1, N_POINTS, 3)).contiguous()
    pb = (pc2 + 0.05 * randn(1, N_POINTS, 3)).contiguous()
    feats = feats2 = randn(1, N_POINTS, c)
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
        bound=group2_bound(1, n, m, k, c, f32, wb))

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
        bound=scatter_bound(1, n, k, c, f32, N_POINTS))

    out["scatter_add"]["alone"] = queued_ms(lambda: banded.scatter_add(
        idx_l0, vals, plan_l0, params_l0, N_POINTS))
    # the other kernels alone too (for rows 3-9 of PERF.md's kernel table)
    out["scatter_softmax_sum"]["alone"] = queued_ms(
        lambda: banded.scatter_softmax_sum(idx_l0, vals_ss, w_shift, plan_l0,
                                           params_l0, N_POINTS))
    out["regroup"]["alone"] = queued_ms(
        lambda: banded.regroup(idx_l0, cost, plan_l0, params_l0))
    out["knn"]["alone"] = queued_ms(
        lambda: banded.knn(pc1, pc2, 16, plan_l0, params_l0))
    out["knn_group2"]["alone"] = queued_ms(
        lambda: banded.knn_group2(pc1, qb, pc2, pb, feats2, 16, plan_l0,
                                  params_l0))

    # cost_attention at both launches of a scan: the record is level 0's,
    # with the scan's sum of the two beside it
    levels = cost_attention_levels(frames, dev)
    per_level = {n: kernel_cost_attention(*args)
                 for n, args in sorted(levels.items(), reverse=True)}
    out["cost_attention"] = per_level[N_POINTS]
    out["cost_attention"]["per_scan"] = dict(
        alone=sum(r["alone"] for r in per_level.values()),
        bound=sum(r["bound"][0] for r in per_level.values()))
    for n, r in per_level.items():
        say("kernels", f"cost_attention {r['shape']}: kernel {r['ms']:.4f} "
            f"ms, alone {r['alone']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), share alone "
            f"{r['bound'][0] / r['alone']:.3f}")
    inputs = levels[N_POINTS]
    # what the recheck costs: level 0 alone without it (measurement build),
    # and how far the kernel then lies from its plain version
    with cuda_build.variant(*RECHECK_BUILD):
        got = attention.cost_attention_fused(*inputs)
        bare = queued_ms(lambda: attention.cost_attention_fused(*inputs))
    _, _, agreement = cost_attention_agreement(
        got, attention.cost_attention_plain(*inputs))
    say("kernels", f"cost_attention N={N_POINTS} without the recheck "
        f"(-D{RECHECK_BUILD[1][0]}): alone {bare:.4f} ms against "
        f"{per_level[N_POINTS]['alone']:.4f} ms shipped; agreement "
        f"{agreement}")
    # the scatters' value-load width (measurement builds), level 0 alone:
    # each build held as the shipped library is
    by_vec = {}
    for vec, build in zip(SCATTER_VECS, VEC_BUILDS):
        with cuda_build.variant(*build):
            got = banded.scatter_softmax_sum(idx_l0, vals_ss, w_shift,
                                             plan_l0, params_l0, N_POINTS)
            err = (got - want_ss).abs()
            check(bool((err <= 1e-5 + 1e-5 * want_ss.abs()).all()),
                  "kernels", f"scatter_softmax_sum VEC={vec} differs by "
                  f"{err.max().item()}")
            by_vec[vec] = queued_ms(lambda: banded.scatter_softmax_sum(
                idx_l0, vals_ss, w_shift, plan_l0, params_l0, N_POINTS))
    say("kernels", f"scatter_softmax_sum N={N_POINTS} K=16 C=64 bf16 alone "
        f"by value-load width (-DSSF_SCATTER_VEC): " + ", ".join(
            f"VEC={v} {t:.4f}" for v, t in by_vec.items()) + f" ms, shipped "
        f"(VEC=2) {out['scatter_softmax_sum']['alone']:.4f}")
    out["attention"] = kernel_attention(
        inputs[0], inputs[1],
        *cost_attention_levels(frames, dev, pairs=4)[N_POINTS][:2])
    for name, r in out.items():
        alone = f", alone {r['alone']:.4f} ms" if "alone" in r else ""
        say("kernels", f"{name} {r['shape']}: kernel {r['ms']:.4f} ms"
            f"{alone}, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), max_abs_err "
            f"{r['max_abs_err']:.3g}")
    return out


# the main paths' knn_group and knn_idw calls by (N, M, k): their layers
# (ssfc's SegNet adds two knn_group shapes)
SPLIT_LAYERS = {
    "knn_group": {(2048, 8192, 16): "sa1", (512, 2048, 16): "sa2",
                  (2048, 512, 16): "su1", (8192, 2048, 16): "su0",
                  (2048, 2048, 16): "flow1_r", (8192, 8192, 16): "flow0_r",
                  (1024, 8192, 16): "segnet sa1",
                  (8192, 1024, 8): "segnet fp1"},
    "knn_idw": {(8192, 2048, 7): "L0 upsample_multi",
                (8192, 2048, 3): "L0 upsample_flow",
                (8192, 8192, 7): "L0 point_warping",
                (2048, 512, 5): "L1 upsample_multi",
                (2048, 512, 3): "L1 upsample_flow",
                (2048, 2048, 7): "L1 point_warping"},
}


# the main path's regroup and scatter_softmax_sum calls by query count:
# the banded cost volume of each level
BAND_KERNELS = ("regroup", "scatter_softmax_sum")
BAND_LAYERS = {8192: "flow0_r", 2048: "flow1_r"}


def split_build(split: int):
    """A context in which the kNN kernels launch with S = split lanes per
    query (a measurement build of band_knn.cu); 0: the shipped library,
    whose S depends on the query count."""
    from ssf_slam_tpu_torch.ops import cuda_build

    if split == 0:
        return contextlib.nullcontext()
    return cuda_build.variant(*SPLIT_BUILDS[SPLITS.index(split)])


def main_path_calls(frames, dev, pairs: int = 1) -> dict:
    """{kernel: {shape key: [inputs, calls]}} of knn_group, knn_idw,
    regroup and scatter_softmax_sum in a 2-frame bf16 run of the ssfc main
    path, which runs the SSF main path's calls and the SegNet's
    (fuse_attention off; the carry's tower, then two scans), the inputs of
    each shape's first call kept. With ``pairs`` > 1 it runs frame pairs
    (0, 1), (2, 3), ... and joins each shape's inputs from those runs
    along the batch axis, so that every member of the batch is a distinct
    scan; the calls are those of the first run."""
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused
    from ssf_slam_tpu_torch.ops import banded

    names = (*SPLIT_LAYERS, *BAND_KERNELS)
    wrapped = {name: getattr(banded, name) for name in names}
    runs = []

    def spy(name):
        def call(*args):
            if name in SPLIT_LAYERS:
                query, points, feats, k, plan, params = args
                key = (query.shape[0], query.shape[1], points.shape[1], k,
                       feats.shape[-1], str(feats.dtype).split(".")[-1],
                       params[1] * params[2])
            else:  # regroup (idx, feats, ...), softmax sum (idx, vals, ...)
                idx, vals = args[:2]
                key = (*idx.shape, vals.shape[-1],
                       str(vals.dtype).split(".")[-1], args[-1]
                       if name == "scatter_softmax_sum" else vals.shape[1])
            seen = runs[-1][name]
            if key not in seen:
                seen[key] = [map_inputs(args, torch.Tensor.clone), 0]
            seen[key][1] += 1
            return wrapped[name](*args)
        return call

    model, seg = bf16_model(dev, fuse=False), seg_model(dev)
    for name in names:
        setattr(banded, name, spy(name))
    try:
        for i in range(pairs):
            runs.append({name: {} for name in names})
            run_sequence_fused(model, frames[2 * i:2 * i + 2], device=dev,
                               seg_apply=seg)
    finally:
        for name, fn in wrapped.items():
            setattr(banded, name, fn)
    torch.cuda.synchronize()
    first = runs[0]
    for name, shapes in first.items():
        for key, entry in shapes.items():
            members = [r[name].get(key) for r in runs]
            check(all(m is not None for m in members), "kernels",
                  f"{name} {key}: a shape of pair 0 is missing from a "
                  "later pair's run")
            if pairs > 1 and all(m is not None for m in members):
                entry[0] = join_inputs([m[0] for m in members])
    return first


def time_split(name: str, args, tag: str, cold: bool = False) -> float:
    """One kNN kernel (knn, knn_group, knn_group2, knn_idw) at one shape:
    exact against its plain version (knn_idw's output as phase 2 holds it)
    with the shipped library and with each measurement build of S. Timed
    with cuda_ms (the yardstick of every ms in phase 2; cold too if asked)
    beside the plain version and its bound, and alone (queued_ms) with the
    shipped library and with each S. Prints one [kernels] line; returns the
    shipped library's time alone."""
    from ssf_slam_tpu_torch.ops import banded

    kernel, plain = getattr(banded, name), getattr(banded, name + "_plain")
    if name == "knn":
        (q, p, k, plan, params), f = args, None
    elif name == "knn_group2":
        q, _, p, _, f, k, plan, params = args
    else:
        q, p, f, k, plan, params = args
    want = plain(*args)

    def held(build: str) -> None:
        got = kernel(*args)
        if name != "knn_idw":
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  "kernels", f"{name} {tag} {build}: differs from plain")
            return
        check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
              "kernels", f"{name} {tag} {build}: sqdist/idx differ")
        # float32: the same operations (1e-5 relative as the tests); bf16:
        # one rounding step, as for the level-0 record above
        rel = 2.0 ** -8 if f.dtype == torch.bfloat16 else 1e-5
        err = (got[0].float() - want[0].float()).abs()
        check(bool((err <= 1e-6 + rel * want[0].float().abs()).all()),
              "kernels", f"{name} {tag} {build}: out differs by {err.max()}")

    by_split = {}
    for split in SPLITS + (0,):
        with split_build(split):
            held(f"S={split}")
            by_split[split] = queued_ms(lambda: kernel(*args))
    b, n, _ = q.shape
    m, wb = p.shape[1], params[1] * params[2]
    alone = by_split.pop(0)
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    if f is None:
        shape = f"B={b} {n}<-{m} k={k}"
        bound_ms, bound_by = knn_bound(b, n, m, k, wb)
    else:
        c, es = f.shape[-1], f.element_size()
        shape = (f"B={b} {n}<-{m} k={k} C={c} "
                 f"{str(f.dtype).split('.')[-1]}")
        bound_ms, bound_by = {"knn_group": group_bound,
                              "knn_group2": group2_bound,
                              "knn_idw": idw_bound}[name](b, n, m, k, c, es,
                                                          wb)
    cold_note = f", cold {cold_ms(lambda: kernel(*args)):.4f}" if cold else ""
    say("kernels", f"{name} {tag} {shape} wb={wb}: kernel {ms:.4f} ms"
        f"{cold_note}; alone {alone:.4f} ms ("
        + ", ".join(f"S={sp} {t:.4f}" for sp, t in by_split.items())
        + f"), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), share {bound_ms / ms:.3f}, alone "
        f"{bound_ms / alone:.3f}")
    return alone


def scatter_atomics(idx, plan, params, n_out) -> tuple[int, int]:
    """(band rows reached, kept entries): the scatter kernels'
    device-memory atomics per channel, one for each (query tile, band row
    its entries reach) at one part a tile and one warp range a row, against
    one for each kept entry (one warp per entry, atomics straight into
    device memory)."""
    from ssf_slam_tpu_torch.ops import banded

    bsz, n, k = idx.shape
    keep = banded._in_band(idx, plan[0], params) & (idx < n_out)
    tile = (torch.arange(bsz * n, device=idx.device).view(bsz, n, 1)
            // params[0]).expand(-1, -1, k)
    pairs = (tile.long() * n_out + idx.long())[keep]
    return int(torch.unique(pairs).numel()), int(keep.sum())


def scatter_agreement(got, idx, vals, plan, params, n_out):
    """(within, max error): scatter_add's output against scatter_add_plain,
    within 1e-5 + 1e-5 |want| beyond the rounding bound of two float32 sums
    in two orders (banded.scatter_add_slack). At batch 4 sums of up to ~80
    unit terms cancel, and index_add_'s float32 atomics and the kernel's
    lie farther apart than 1e-5 + 1e-5 |want| from each other there."""
    from ssf_slam_tpu_torch.ops import banded

    want = banded.scatter_add_plain(idx, vals, plan, params, n_out).double()
    # banded.scatter_add_slack, written out: chip_ab.py holds older
    # checkouts, which lack it, to this agreement too
    mag = banded.scatter_add_plain(idx, vals.float().abs(), plan, params,
                                   n_out).double()
    count = banded.scatter_add_plain(
        idx, torch.ones_like(vals[..., :1], dtype=torch.float32), plan,
        params, n_out).double()
    slack = 2.0 * (count - 1.0).clamp(min=0.0) * 2.0 ** -24 * mag
    err = (got.double() - want).abs()
    return (bool((err <= 1e-5 + 1e-5 * want.abs() + slack).all()),
            err.max().item())


def time_scatter(tag: str, idx, vals, plan, params, n_out,
                 vecs: bool = False) -> tuple:
    """scatter_add at one shape: against its plain version
    (scatter_agreement), timed under cuda_ms and alone beside its bound;
    prints one [kernels] line with its device-memory atomics. With
    ``vecs``, also alone with each measurement build of the value-load width
    (each held as the shipped library). Returns (alone ms, bound ms,
    {VEC: alone ms})."""
    from ssf_slam_tpu_torch.ops import banded, cuda_build

    def run():
        return banded.scatter_add(idx, vals, plan, params, n_out)

    got = run()
    ok, err = scatter_agreement(got, idx, vals, plan, params, n_out)
    check(ok, "kernels", f"scatter_add {tag} differs by {err}")
    by_vec = {}
    for vec, build in zip(SCATTER_VECS, VEC_BUILDS) if vecs else ():
        with cuda_build.variant(*build):
            ok, e = scatter_agreement(run(), idx, vals, plan, params, n_out)
            check(ok, "kernels", f"scatter_add {tag} VEC={vec} differs by "
                  f"{e}")
            by_vec[vec] = queued_ms(run)
    b, n, k, c = vals.shape
    ms = cuda_ms(run)
    alone = queued_ms(run)
    bound_ms, bound_by = scatter_bound(b, n, k, c, vals.element_size(),
                                       n_out)
    rows, entries = scatter_atomics(idx, plan, params, n_out)
    say("kernels", f"scatter_add {tag} B={b} N={n} K={k} C={c} "
        f"{str(vals.dtype).split('.')[-1]} -> {n_out} rows (wblk "
        f"{params[1]}): kernel {ms:.4f} ms, alone {alone:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), share alone "
        f"{bound_ms / alone:.3f}; device-memory atomics {rows} x C "
        f"against {entries} x C ({entries / max(rows, 1):.2f}x fewer); "
        f"max_abs_err {err:.3g}" + "".join(
            f"; VEC={v} alone {t:.4f}" for v, t in by_vec.items()))
    return alone, bound_ms, by_vec


def softmax_agreement(got, idx, vals, w_shift, plan, params, n_out):
    """(within, max error): scatter_softmax_sum's output against its plain
    version, within 1e-5 + 1e-5 |want| beyond the rounding bound of two
    float32 sums of its terms in two orders (banded.
    scatter_softmax_sum_slack, written out as scatter_agreement writes
    scatter_add's, for older checkouts)."""
    from ssf_slam_tpu_torch.ops import banded

    args = (w_shift, plan, params, n_out)
    want = banded.scatter_softmax_sum_plain(idx, vals, *args).double()
    mag = banded.scatter_softmax_sum_plain(idx, vals.abs(), *args).double()
    count = banded.scatter_add_plain(
        idx, torch.ones_like(vals[..., :1], dtype=torch.float32), plan,
        params, n_out).double()
    slack = 2.0 * (count - 1.0).clamp(min=0.0) * 2.0 ** -24 * mag
    err = (got.double() - want).abs()
    return (bool((err <= 1e-5 + 1e-5 * want.abs() + slack).all()),
            err.max().item())


def map_inputs(args, fn) -> tuple:
    """A banded kernel call's inputs with fn applied to every tensor and to
    the plan's b0 (the plan's n_valid, k and the band params stay)."""
    return tuple((fn(a[0]), a[1]) if isinstance(a, tuple)
                 and isinstance(a[0], torch.Tensor) else
                 fn(a) if isinstance(a, torch.Tensor) else a for a in args)


def join_inputs(calls: list) -> tuple:
    """The inputs of several calls of one banded kernel at one shape
    joined along their batch axis (tensors and the plan's b0; the plan's
    n_valid, k and the band params are those of the first call)."""
    def join(i, a):
        if isinstance(a, tuple) and isinstance(a[0], torch.Tensor):
            return (torch.cat([c[i][0] for c in calls]), a[1])
        if isinstance(a, torch.Tensor):
            return torch.cat([c[i] for c in calls])
        return a
    return tuple(join(i, a) for i, a in enumerate(calls[0]))


def first_members(args, bsz: int) -> tuple:
    """A batched call's inputs cut to their first bsz members."""
    return map_inputs(args, lambda t: t[:bsz].contiguous())


def time_band(name: str, args, tag: str) -> None:
    """regroup (exact against its plain version) or scatter_softmax_sum
    (softmax_agreement) at one shape, timed under cuda_ms and alone beside
    its plain version and its bound; prints one [kernels] line."""
    from ssf_slam_tpu_torch.ops import banded

    kernel, plain = getattr(banded, name), getattr(banded, name + "_plain")
    got = kernel(*args)
    if name == "regroup":
        idx, feats, plan, params = args
        check(torch.equal(got, plain(*args)), "kernels",
              f"regroup {tag} differs from plain")
        b, n, k = idx.shape
        m, c = feats.shape[1:]
        es, err = feats.element_size(), 0.0
        shape = f"B={b} [{n},{k}]x[{m},{c}]"
        bound_ms, bound_by = bound(b * (n * k * 4 + m * c * es
                                        + n * k * c * es), 0)
    else:
        idx, vals, w_shift, plan, params, n_out = args
        ok, err = softmax_agreement(got, *args)
        check(ok, "kernels", f"scatter_softmax_sum {tag} differs by {err}")
        b, n, k, c = vals.shape
        es = vals.element_size()
        shape = f"B={b} N={n} K={k} C={c} -> {n_out}"
        bound_ms, bound_by = bound(
            b * (n * k * 4 + n * k * c * es + n * k * 4 + n_out * (c + 1) * 4),
            b * n * k * (c + 1) * 3)
    dt = str(args[1].dtype).split(".")[-1]
    ms = cuda_ms(lambda: kernel(*args))
    alone = queued_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    say("kernels", f"{name} {tag} {shape} {dt}: kernel {ms:.4f} ms, alone "
        f"{alone:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), share alone {bound_ms / alone:.3f}; max_abs_err "
        f"{err:.3g}")


@contextlib.contextmanager
def spy_scatter(store: dict):
    """Within the block, every scatter_add call goes through to the kernel
    and leaves in ``store`` {(vals shape, type, wblk, n_out): [inputs of
    the first call, calls]}."""
    from ssf_slam_tpu_torch.ops import banded

    kernel = banded.scatter_add

    def call(idx, vals, plan, params, n_out):
        key = (tuple(vals.shape), str(vals.dtype).split(".")[-1], params[1],
               n_out)
        if key not in store:
            store[key] = [(idx.clone(), vals.clone(),
                           (plan[0].clone(), plan[1]), params, n_out), 0]
        store[key][1] += 1
        return kernel(idx, vals, plan, params, n_out)

    banded.scatter_add = call
    try:
        yield
    finally:
        banded.scatter_add = kernel


def time_train_scatters(shapes: dict, label: str, vecs: bool = False) -> None:
    """scatter_add at every shape of a train step's segment sums (from
    spy_scatter), and their sum per step, alone, beside the bound (and,
    with ``vecs``, with each measurement build of the value-load width)."""
    total = bound_total = 0.0
    total_vec = dict.fromkeys(SCATTER_VECS, 0.0) if vecs else {}
    for key, (args, calls) in shapes.items():
        alone, bound_ms, by_vec = time_scatter(f"{label} x{calls}", *args,
                                               vecs=vecs)
        total += calls * alone
        bound_total += calls * bound_ms
        for vec, t in by_vec.items():
            total_vec[vec] += calls * t
    calls = sum(c for _, c in shapes.values())
    say("train", f"scatter_add, {label} step: {calls} segment sums over "
        f"{len(shapes)} shapes, {total:.4f} ms per step "
        f"alone, bound {bound_total:.4f} ms, share {bound_total / total:.3f}"
        + "".join(f"; VEC={v} {t:.4f} ms" for v, t in total_vec.items()))


def phase_shapes(frames, dev) -> None:
    """knn_group and knn_idw at every distinct shape of the main path's
    scan, batch 1 and 8 (the batched serving path's, eight distinct frame
    pairs' inputs; batch 4 their first four); at the level-0
    shapes also at batch 4 (the training step's) and cold. Each exact
    against its plain version at every split S; times at each S. regroup
    (exact) and scatter_softmax_sum (softmax_agreement) at every distinct
    shape of the scan, batch 1, 4 and 8. Then scatter_add at the level-0
    shape, batch 1, 4 and 8, float32 and bf16 values."""
    from ssf_slam_tpu_torch.engine.fused import sequence_box, stack_fused_scans
    from ssf_slam_tpu_torch.ops import banded
    from ssf_slam_tpu_torch.ops import neighbors as nb

    # every shape's inputs from the runs of frame pairs (0, 1) ... (14, 15):
    # eight distinct members, so that a kernel reading one member's rows
    # for another's (a wrong batch stride) disagrees with its plain version
    for name, shapes in main_path_calls(frames, dev, SERVE_BATCH).items():
        for key, (args, calls) in sorted(shapes.items()):
            tag = f"({calls} calls in the 2-scan run)"
            if name in SPLIT_LAYERS:
                layer = SPLIT_LAYERS[name].get((key[1], key[2], key[3]), "?")
                # batch 1 and the batched serving path's batch 8
                for inputs in (first_members(args, 1), args):
                    time_split(name, inputs, f"{layer} {tag}")
                continue
            # regroup and scatter_softmax_sum at batch 1, the train step's
            # batch 4 and the batched serving path's batch 8
            layer = BAND_LAYERS.get(key[1], "?")
            for inputs in (first_members(args, 1),
                           first_members(args, TRAIN_BATCH), args):
                time_band(name, inputs, f"{layer} {tag}")
    # level 0 at batch 1, 4 and 8, warm and cold: frames 2i -> 2i + 1,
    # each sorted under the sequence box as sorted_pair sorts frames 0, 1
    scans = stack_fused_scans(frames, N_POINTS)
    box = sequence_box(scans["points"], device=dev)
    clouds = [nb.morton_sort(torch.as_tensor(scans["points"][i:i + 1],
                                             device=dev), box=box)[0]
              for i in range(2 * SERVE_BATCH)]
    gen = torch.Generator(device=dev).manual_seed(2)
    for bsz in (1, TRAIN_BATCH, SERVE_BATCH):
        q = torch.cat(clouds[0:2 * bsz:2])
        p = torch.cat(clouds[1:2 * bsz:2])
        sparse = p[:, ::4].contiguous()
        feats = torch.randn(bsz, N_POINTS, 99, generator=gen, device=dev)
        fields = torch.randn(bsz, sparse.shape[1], 132, generator=gen,
                             device=dev).to(torch.bfloat16)
        params = nb.band_params(N_POINTS, N_POINTS, 16)
        plan = nb.make_plan(q, p, params, 64.0, box)
        grouped = time_split("knn_group", (q, p, feats, 16, plan, params),
                             "flow0_r level 0", cold=True)
        # the entry points on the same selection body: knn (its top-k
        # alone) and knn_group2 (the twin searches: search b's clouds a
        # warped copy of (q, p), under (q, p)'s plan), f32 and bf16 feats
        alone = time_split("knn", (q, p, 16, plan, params), "level 0")
        say("kernels", f"knn against knn_group at B={bsz} 8192<-8192 "
            f"k=16 (C=99 f32), alone: {alone:.4f} ms against "
            f"{grouped:.4f} ms; the grouping copy takes the other "
            f"{grouped - alone:.4f} ms")
        gen_b = torch.Generator(device=dev).manual_seed(3)
        qb = (q + 0.05 * torch.randn(q.shape, generator=gen_b,
                                     device=dev)).contiguous()
        pb = (p + 0.05 * torch.randn(p.shape, generator=gen_b,
                                     device=dev)).contiguous()
        for f in (feats, feats.to(torch.bfloat16)):
            time_split("knn_group2", (q, qb, p, pb, f, 16, plan, params),
                       "level 0", cold=True)
        params = nb.band_params(N_POINTS, sparse.shape[1], 7)
        plan = nb.make_plan(q, sparse, params, 64.0, box)
        time_split("knn_idw", (q, sparse, fields, 7, plan, params),
                   "upsample_multi level 0", cold=True)
        # the level-0 cost volume's segment sum: 8192 x 16 x 99 into 8192
        params = nb.band_params(N_POINTS, N_POINTS, 16)
        plan = nb.make_plan(q, p, params, 64.0, box)
        _, idx, _ = banded.knn_group(q, p, feats, 16, plan, params)
        cot = torch.randn(bsz, N_POINTS, 16, 99, generator=gen, device=dev)
        for vals in (cot, cot.to(torch.bfloat16)):
            time_scatter("level 0", idx, vals, plan, params, N_POINTS)


def cost_attention_inputs(frames, dev):
    """(q_feat, k_feat, q_cost, folded weightnet) of the level-0 cost
    volume (flow0_r, 8192 points) on the bf16 path, frame pair (0, 1)."""
    return cost_attention_levels(frames, dev)[N_POINTS]


def cost_attention_levels(frames, dev, pairs: int = 1) -> dict:
    """{points: (q_feat, k_feat, q_cost, folded weightnet)} of the two cost
    volumes (flow0_r at 8192 points, flow1_r at 2048) on the bf16 path,
    frame pair (0, 1): the inputs of the two launches of a scan; with
    ``pairs`` > 1 those of frame pairs (0, 1), (2, 3), ... stacked into a
    batch."""
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

    costvolume.cost_attention_fused = keep
    try:
        for p in range(pairs):
            pcs = [torch.as_tensor(f["pos1"][None], device=dev)
                   for f in frames[2 * p:2 * p + 2]]
            with torch.inference_mode():
                model(*pcs)
    finally:
        costvolume.cost_attention_fused = fused
    by_n = {}
    for args in seen:
        by_n.setdefault(args[0].shape[1], []).append(args)
    return {n: tuple(torch.cat([a[i] for a in runs]) for i in range(3))
            + (runs[0][3],) for n, runs in by_n.items()}


def cost_attention_agreement(got, want) -> tuple[bool, float, str]:
    """(within COST_ATTENTION_TOL, max abs error, a line of the agreement)
    of cost_attention's (cost_fwd bf16, w_k float32) against its plain
    version's."""
    tol = COST_ATTENTION_TOL
    if got[0].dtype != torch.bfloat16 or got[1].dtype != torch.float32:
        return False, float("inf"), f"output types {got[0].dtype}, " \
            f"{got[1].dtype}"
    err_cf = (got[0].float() - want[0].float()).abs()
    err_wk = (got[1] - want[1]).abs()
    ref = want[0].float().abs()
    rms = ref.pow(2).mean().sqrt()
    one_step = (err_cf <= tol["cf_abs"] + tol["cf_rel"] * ref).float().mean()
    wk_ok = (err_wk <= tol["wk_abs"]).float().mean().item()
    steps = (err_cf / (2.0 ** -8 * (ref + rms))).max().item()
    ok = (one_step.item() >= tol["share"]
          and bool((err_cf <= tol["cf_all"] * (ref + rms)).all())
          and wk_ok >= tol["share"] and err_wk.max().item() <= tol["wk_all"])
    return ok, max(err_cf.max().item(), err_wk.max().item()), (
        f"cost_fwd equal on {(err_cf == 0).float().mean().item():.6f}, "
        f"within one step on {one_step.item():.6f}, at most {steps:.3f} "
        f"steps of (|value| + rms); w_k within {tol['wk_abs']} on "
        f"{wk_ok:.6f}, at most {err_wk.max().item():.3g}")


def kernel_cost_attention(q, k, qc, wn) -> dict:
    """cost_attention on one launch's inputs against its plain version
    (COST_ATTENTION_TOL), timed under cuda_ms and alone (queued_ms)."""
    from ssf_slam_tpu_torch.ops import attention

    _, n, kk, c = q.shape
    c2 = wn[2].shape[1]
    got = attention.cost_attention_fused(q, k, qc, wn)
    want = attention.cost_attention_plain(q, k, qc, wn)
    ok, max_err, agreement = cost_attention_agreement(got, want)
    say("kernels", f"cost_attention N={n} agreement: {agreement}")
    check(ok, "kernels", f"cost_attention N={n} misses COST_ATTENTION_TOL: "
          f"{agreement}")
    # multiply-adds per point: S, q' and k' (3 K*K*C), the weightnet on
    # 2K rows (C*C + C*C2 + C2 each) and the aggregation (K*C); x2 FLOP
    flops = 2 * n * (3 * kk * kk * c + 2 * kk * (c * c + c * c2 + c2)
                     + kk * c)
    nbytes = (3 * n * kk * c * 2 + sum(t.numel() for t in wn) * 4
              + n * c * 2 + n * kk * 4)
    return dict(
        max_abs_err=max_err, shape=f"[{n},{kk},{c}] C2={c2} bf16",
        ms=cuda_ms(lambda: attention.cost_attention_fused(q, k, qc, wn)),
        alone=queued_ms(lambda: attention.cost_attention_fused(q, k, qc,
                                                               wn)),
        plain_ms=cuda_ms(lambda: attention.cost_attention_plain(q, k, qc,
                                                                wn)),
        # no single PyTorch call computes the chain (attention, an MLP and
        # a weighted reduction)
        library_ms=None,
        bound=bound(nbytes, flops, PEAK_BF16))


def attention_agreement(got, want) -> tuple[bool, float, str]:
    """(within its tolerance, max abs error, a line of the agreement) of
    attention's (q', k') against its plain version's: bf16 within
    ATTENTION_TOL, float32 within 1e-5 + 1e-5 |value| (sum orders)."""
    dt = want[0].dtype
    if any(g.dtype != dt or g.shape != w.shape for g, w in zip(got, want)):
        return False, float("inf"), "output types or shapes differ"
    errs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
    refs = [w.float().abs() for w in want]
    max_err = max(e.max().item() for e in errs)
    equal = min((e == 0).float().mean().item() for e in errs)
    if dt == torch.float32:
        ok = all(bool((e <= 1e-5 + 1e-5 * r).all())
                 for e, r in zip(errs, refs))
        return ok, max_err, f"float32: equal on {equal:.6f}, max error " \
            f"{max_err:.3g} (held to 1e-5 + 1e-5 |value|)"
    tol = ATTENTION_TOL
    shares, worst = [], 0.0
    for e, r in zip(errs, refs):
        rms = r.pow(2).mean().sqrt()
        shares.append((e <= 1e-6 + tol["step"] * r).float().mean().item())
        worst = max(worst, (e / (tol["step"] * (r + rms))).max().item())
    ok = min(shares) >= tol["share"] and worst <= tol["all_steps"]
    return ok, max_err, f"equal on {equal:.6f}, within one bf16 step on " \
        f"{min(shares):.6f}, at most {worst:.3f} steps of (|value| + rms)"


def kernel_attention(q, k, q4, k4) -> dict:
    """The dual-softmax attention alone on the level-0 cost volume's
    q_feat / k_feat (bf16 [1, 8192, 16, 64]) against its plain version,
    timed under cuda_ms and alone (queued_ms); then held and timed alone
    at batch 4 (q4, k4: frame pairs 0-3) and in float32."""
    from ssf_slam_tpu_torch.ops import attention

    _, n, kk, c = q.shape
    body = attention.attention_body(q.dtype, kk, c)
    got = attention.attention_fused(q, k)
    ok, max_err, line = attention_agreement(
        got, attention.attention_plain(q, k))
    say("kernels", f"attention [{n},{kk},{c}] bf16, body {body}: {line}")
    check(ok, "kernels", f"attention misses its tolerance: {line}")
    record = dict(
        max_abs_err=max_err, shape=f"[{n},{kk},{c}] bf16",
        ms=cuda_ms(lambda: attention.attention_fused(q, k)),
        alone=queued_ms(lambda: attention.attention_fused(q, k)),
        plain_ms=cuda_ms(lambda: attention.attention_plain(q, k)),
        # no one call computes the dual-softmax product
        library_ms=None,
        # two inputs read and two outputs written; S, q' and k' are 3 K*K*C
        # multiply-adds a point, on the bf16 tensor cores in the "mma"
        # body, on the float32 CUDA cores in the "simt" one
        bound=bound(4 * n * kk * c * 2, 2 * n * 3 * kk * kk * c,
                    PEAK_BF16 if body == "mma" else PEAK_F32))
    for tag, (a, b) in (("B=4 bf16", (q4, k4)),
                        ("B=1 float32", (q.float(), k.float()))):
        ok, _, line = attention_agreement(attention.attention_fused(a, b),
                                          attention.attention_plain(a, b))
        check(ok, "kernels", f"attention {tag} misses its tolerance: {line}")
        record[tag] = queued_ms(lambda: attention.attention_fused(a, b))
        say("kernels", f"attention {tag} {list(a.shape)}, body "
            f"{attention.attention_body(a.dtype, kk, c)}: {line}; alone "
            f"{record[tag]:.4f} ms")
    return record


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
                  fuse: bool, n: int = 8) -> float:
    """Device time by kernel over n bf16 scans (torch.profiler), written to
    out_dir/profile_<name>.txt; the device busy share is the profiled device
    time per scan over the unprofiled host time per scan (the median of the
    runs in turns). Then the host syncs of n scans
    (torch.cuda.set_sync_debug_mode), counted by the port's source lines
    that reach them. Returns the device ms per scan."""
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
    return dev_ms


# ---------------------------------------------------------------------------
# loop closure: tests/test_torch_slam.py's out-and-back circuit on the card
# ---------------------------------------------------------------------------


LOOP_FIXTURE = os.path.join(FIXTURES, "ssf_slam_small_ref.npz")
# the circuit's gates, as tests/test_torch_slam.py::LOOP_STEP scales them
LOOP_MAPPING = dict(max_keyframes=96, loop_search_radius=8.0,
                    loop_time_gap=5.0, loop_skip_after_close=10,
                    submap_points=4096)
# pose_t and odom_t against the JAX run of the circuit (fixture keys
# loop/*), in metres: the CPU test's tolerance (test_torch_slam.py::
# test_loop_closure_full_engine_matches_jax); the card has read 1.56e-4 m
LOOP_TOL = 1e-3


def phase_loop(dev) -> None:
    """The SSF run_sequence with a provided flow (ground truth x 1.03, an
    odometry drift) and the ground-truth static mask over 72 frames of the
    out-and-back circuit (1024 points): loop closure, ICP and the pose
    graph on the card, against the JAX fixture: n_loops equal and > 0,
    is_keyframe equal, pose_t and odom_t within LOOP_TOL."""
    from ssf_slam_tpu_torch import config as tc
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.engine.pipeline import run_sequence

    frames = generate_sequence(n_frames=72, n_points=1024, seed=21,
                               noise=0.004, n_moving=0, trajectory="loop")
    for f in frames:
        f["gt"] = f["gt"] * 1.03
        f["static_mask"] = f["s_fg_mask"] < 0.5
    cfg = tc.PipelineConfig(variant=tc.Variant.SSF,
                            lidar=tc.LidarConfig(max_points=1024),
                            features=tc.FeatureConfig(),
                            mapping=tc.MappingConfig(**LOOP_MAPPING))
    with np.load(LOOP_FIXTURE) as z:
        want = {k[len("loop/"):]: z[k] for k in z.files
                if k.startswith("loop/")}
    t0 = time.perf_counter()
    state, got = run_sequence(frames, cfg, device=dev)
    dt = time.perf_counter() - t0
    n_loops, n_want = int(state.map_state.n_loops), int(want["n_loops"])
    dpt = float(np.abs(got["pose_t"] - want["pose_t"]).max())
    dot = float(np.abs(got["odom_t"] - want["odom_t"]).max())
    kf = int((got["is_keyframe"] != want["is_keyframe"]).sum())
    say("loop", f"72-frame circuit, 1024 points, on {dev}: {n_loops} loop "
        f"closures (JAX {n_want}), max |d pose_t| {dpt:.3g} m, odom_t "
        f"{dot:.3g} m, is_keyframe differs on {kf} frames; {dt:.1f} s")
    check(np.isfinite(got["pose_t"]).all(), "loop", "non-finite pose_t")
    check(n_want > 0 and n_loops == n_want, "loop",
          f"{n_loops} loop closures, JAX {n_want}")
    check(kf == 0, "loop", f"is_keyframe differs on {kf} frames")
    check(dpt <= LOOP_TOL, "loop", f"pose_t differs by {dpt} m")
    check(dot <= LOOP_TOL, "loop", f"odom_t differs by {dot} m")


OVERFLOW_FIXTURE = os.path.join(FIXTURES, "mapping_overflow_ref.npz")
# the overflow case's poses against the JAX run, at every step: the CPU
# test's tolerance (test_torch_mapping.py::
# test_mapping_step_keyframe_overflow_matches_fixture)
OVERFLOW_TOL = 1e-4
OVERFLOW_STATE = ("kf_q", "kf_t", "cur_q", "cur_t")


def phase_overflow(dev) -> None:
    """The keyframe buffer past max_keyframes on the card: mapping_step
    over tests/test_torch_mapping.py's overflow case (the square loop's 21
    keyframes into 5 slots), under inference mode as the sequence runners
    call it, against the committed JAX run: keyframe flags, n_kf and
    n_loops equal at every step, OVERFLOW_STATE within OVERFLOW_TOL, the
    loop slots equal."""
    from ssf_slam_tpu_torch.config import MappingConfig
    from ssf_slam_tpu_torch.mapping.keyframes import (
        init_map_state,
        mapping_step,
    )

    with np.load(OVERFLOW_FIXTURE) as z:
        ref = {n: z[n] for n in z.files}
    cfg = MappingConfig(**json.loads(str(ref["gates"])))
    world = torch.as_tensor(ref["world"], device=dev)
    state = init_map_state(cfg.max_keyframes, len(world), device=dev)
    mask = torch.ones(len(world), dtype=torch.bool, device=dev)
    qid = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    worst = 0.0
    with torch.inference_mode():
        for k in range(len(ref["odom_t"])):
            state, out = mapping_step(
                state, qid, torch.as_tensor(ref["odom_t"][k], device=dev),
                world - torch.as_tensor(ref["true_t"][k], device=dev), mask,
                float(k), cfg)
            check(out["is_keyframe"] == bool(ref["is_keyframe"][k])
                  and state.n_kf == int(ref["n_kf"][k])
                  and state.n_loops == int(ref["n_loops"][k]), "loop",
                  f"overflow step {k}: keyframe {out['is_keyframe']}, "
                  f"n_kf {state.n_kf}, n_loops {state.n_loops}; JAX "
                  f"{bool(ref['is_keyframe'][k])}, {int(ref['n_kf'][k])}, "
                  f"{int(ref['n_loops'][k])}")
            for n in OVERFLOW_STATE:
                got = getattr(state, n).cpu().numpy()
                worst = max(worst, float(np.abs(got - ref[n][k]).max()))
    slots = all(np.array_equal(getattr(state, n).cpu().numpy(), ref[n])
                for n in ("loop_a", "loop_b"))
    past = int((ref["loop_a"][:state.n_loops] >= cfg.max_keyframes).sum())
    say("loop", f"keyframe overflow on {dev}: {state.n_kf} keyframes into "
        f"{cfg.max_keyframes} slots, {state.n_loops} loop closures ({past} "
        f"past the buffer) as JAX; max |d| of {', '.join(OVERFLOW_STATE)} "
        f"over the steps {worst:.3g}; loop slots equal: {slots}")
    check(state.n_kf > cfg.max_keyframes and past > 0, "loop",
          "the overflow case did not overflow")
    check(worst <= OVERFLOW_TOL, "loop", f"overflow poses differ by {worst}")
    check(slots, "loop", "overflow loop slots differ")


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
    shapes_bf16 = {}
    with spy_scatter(shapes_bf16):
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
    shapes_f32 = {}
    with spy_scatter(shapes_f32):
        loss, g_kernel, (loss_t, params) = _grads(model, batches[0],
                                                  loss_cfg, retain=True)
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
    # the segment sums of the bf16 and the f32 step, shape by shape
    time_train_scatters(shapes_bf16, "bf16", vecs=True)
    time_train_scatters(shapes_f32, "f32")
    del shapes_bf16, shapes_f32
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


# ---------------------------------------------------------------------------
# phase 8: the other pipeline variants and geom_refine
# ---------------------------------------------------------------------------


VARIANTS_FIXTURE = os.path.join(FIXTURES, "variants_ref.npz")
# name -> (variant, geom_refine, fused): the full-width f32 runs of
# tests/test_torch_variants.py::FULL_RUNS, held to its JAX fixture
F32_RUNS = {"sf": ("SF", False, True), "sf_refine": ("SF", True, True),
            "ssf_refine": ("SSF", True, True), "seg": ("SEG", False, False),
            "noseg": ("NO_SEG", False, False),
            "onlypc": ("ONLY_PC", False, False)}
# the evo protocol's sequence (README.md's round-5 table: cli evaluate
# --synthetic --seed 100 --frames 40) and its runs: name -> (variant,
# geom_refine, the committed trajectory of the JAX package's TPU run)
EVO_FRAMES, EVO_SEED = 40, 100
EVO_RUNS = {"seg": ("SEG", False, "results_r5/00_SEG.tum"),
            "onlypc": ("ONLY_PC", False, "results_r5/00_ONLYPC.tum"),
            "noseg": ("NO_SEG", False, "results_r5/00_NOSEG.tum"),
            "sf": ("SF", False, "results_r5/00_SF.tum"),
            "ssf": ("SSF", False, "results_r5/00_SSF.tum"),
            "sf_refine": ("SF", True, "results_r5_refine/00_SF.tum"),
            "ssf_refine": ("SSF", True, "results_r5_refine/00_SSF.tum"),
            "ssfc": ("SSFC", False, "results_r5/00_SSFC.tum"),
            "ssfc_refine": ("SSFC", True, "results_r5_refine/00_SSFC.tum")}
# a flow variant's ATE vs the ground truth may exceed that of its committed
# trajectory by this much (m); onlypc is printed beside it, its parity
# held in (a)
EVO_MARGIN = 0.02


def _variant_cfg(variant: str, refine: bool):
    from ssf_slam_tpu_torch import config as tc

    return tc.PipelineConfig(variant=tc.Variant[variant],
                             egomotion=tc.EgoMotionConfig(geom_refine=refine))


def _run_variant(model, frames, variant: str, refine: bool, dev, box=None,
                 seg=None):
    """One run through the entry point a user calls: the fused step for
    SF / SSF (``model``) and ssfc ("SSFC": SSF with the SegNet ``seg`` as
    its classifier), else run_sequence on the frames' ground-truth flow.
    Returns (outputs, seconds on the host clock, ending on the host)."""
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused
    from ssf_slam_tpu_torch.engine.pipeline import run_sequence

    seg_apply = seg if variant == "SSFC" else None
    if seg_apply is not None:
        variant = "SSF"
    cfg = _variant_cfg(variant, refine)
    t0 = time.perf_counter()
    if variant in ("SF", "SSF"):
        got = run_sequence_fused(model, frames, cfg, device=dev, box=box,
                                 use_gmm=variant == "SF",
                                 seg_apply=seg_apply)
    else:
        got = run_sequence(frames, cfg, device=dev)[1]
    return got, time.perf_counter() - t0


def phase_variants(frames, dev, smi: str, main_launches: dict) -> None:
    """(a) the six full-width f32 runs against the JAX fixture; (b) the SF
    main path (bf16, the 32 bench frames, tower caching), counters reset
    just before and read just after, each equal to phase 4's; (c) the evo
    protocol's seven runs on the seed-100 sequence, bf16, each written to a
    TUM file and scored against the ground truth and the seg run, beside
    the committed trajectories."""
    import tempfile

    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.engine.evaluation import (
        ate_rmse,
        read_tum,
        rpe,
        write_tum,
    )
    from ssf_slam_tpu_torch.engine.fused import sequence_box, stack_fused_scans
    from ssf_slam_tpu_torch.weights import load_tflow

    # (a) f32 parity
    n = N_FIXTURE_FRAMES
    with np.load(VARIANTS_FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    fx = frames[:n]  # SEG, NO_SEG and ONLY_PC on the ground-truth flow
    box = sequence_box(stack_fused_scans(fx, N_POINTS)["points"], device=dev)
    f32 = load_tflow(FlowNetConfig(npoint=N_POINTS, joint_seg=True,
                                   neighbor_backend="banded"), device=dev)
    for name, (variant, refine, fused) in F32_RUNS.items():
        got, _ = _run_variant(f32, fx, variant, refine, dev, box)
        want = {k.split("/", 1)[1]: v for k, v in ref.items()
                if k.startswith(name + "/")}
        dt = np.abs(got["rel_t"] - want["rel_t"]).max()
        dr = _rot_angle(got["rel_q"], want["rel_q"]).max()
        dpt = np.abs(got["pose_t"] - want["pose_t"]).max()
        dpr = _rot_angle(got["pose_q"], want["pose_q"]).max()
        say("variants", f"(a) {name}: {n} f32 frames vs JAX: max |d rel_t| "
            f"{dt:.3g} m, rotation {dr:.3g} rad; |d pose_t| {dpt:.3g} m, "
            f"rotation {dpr:.3g} rad; keyframes "
            f"{got['is_keyframe'].astype(int).tolist()}")
        for key in ("rel_t", "pose_t", "pose_q", "odom_t"):
            check(np.isfinite(got[key]).all(), "variants",
                  f"{name}: non-finite {key}")
        check(dt <= 1e-2 and dpt <= 1e-2, "variants",
              f"{name}: rel_t / pose_t differ by {dt} / {dpt} m")
        check(dr <= 1e-3 and dpr <= 1e-3, "variants",
              f"{name}: rotations differ by {dr} / {dpr} rad")
        for key in ("is_keyframe", "n_features"):
            check(np.array_equal(got[key], want[key]), "variants",
                  f"{name}: {key} {got[key].tolist()} != "
                  f"{want[key].tolist()}")
    del f32

    # (b) the SF main path
    model = bf16_model(dev, fuse=False)
    _run_variant(model, frames[:2], "SF", False, dev)  # warm-up
    torch.cuda.synchronize()
    reset_all()
    got, secs = _run_variant(model, frames, "SF", False, dev)
    launches = read_all()
    gt = np.stack([f["pose1"][1] for f in frames])
    ate = ate_rmse(got["pose_t"], gt)
    say("variants", f"(b) SF main path, {len(frames)} frames x {N_POINTS} "
        f"points, bf16: {len(frames) / secs:.2f} scans/s (host clock; "
        f"{smi}), ATE pose_t {ate:.4f} m, odom_t "
        f"{ate_rmse(got['odom_t'], gt):.4f} m, launches {launches}")
    for key in ("pose_q", "pose_t", "rel_q", "rel_t", "odom_t", "flow"):
        check(np.isfinite(got[key]).all(), "variants", f"SF: non-finite {key}")
    for name in (*PER_SCAN, "cost_attention"):
        check(launches[name] == main_launches[name], "variants",
              f"SF: {name} launched {launches[name]} times, phase 4 "
              f"{main_launches[name]}")
    check(ate < 0.5, "variants", f"SF ATE {ate} m")

    # (c) the evo protocol; ssfc's classifier as the JAX CLI builds it
    seg = seg_model(dev)
    evo = generate_sequence(n_frames=EVO_FRAMES, n_points=N_POINTS,
                            seed=EVO_SEED, noise=0.004, n_moving=4)
    gt_pos = np.stack([f["pose1"][1] for f in evo])
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (variant, refine, committed) in EVO_RUNS.items():
            got, secs = _run_variant(model, evo, variant, refine, dev,
                                     seg=seg)
            path = os.path.join(tmp, f"00_{name.upper()}.tum")
            write_tum(path, [f["time"] for f in evo], got["pose_t"],
                      got["pose_q"])
            _, pos, quat = read_tum(path)
            _, cpos, _ = read_tum(committed)
            runs[name] = (pos, quat, ate_rmse(pos, gt_pos),
                          ate_rmse(cpos, gt_pos), len(evo) / secs)
    ref_pos, ref_quat = runs["seg"][:2]
    say("variants", f"(c) evo protocol: seed {EVO_SEED}, {EVO_FRAMES} "
        f"frames x {N_POINTS} points, bf16, the seg run the reference; "
        f"scans/s on the host clock ({smi})")
    say("variants", "| run | ATE vs Seg (m) | RPE trans (m) | RPE rot (deg) "
        "| ATE vs GT (m) | committed ATE vs GT (m) | scans/s |")
    for name, (pos, quat, ate_gt, ate_c, sps) in runs.items():
        if name == "seg":
            cols = "(reference) | | "
        else:
            r = rpe(pos, quat, ref_pos, ref_quat)
            cols = (f"{ate_rmse(pos, ref_pos):.4f} | {r['trans_rmse']:.4f} "
                    f"| {r['rot_rmse_deg']:.4f}")
        say("variants", f"| {name} | {cols} | {ate_gt:.4f} | {ate_c:.4f} | "
            f"{sps:.2f} |")
        check(np.isfinite(pos).all() and np.isfinite(quat).all(),
              "variants", f"{name}: non-finite trajectory")
        if name != "onlypc":
            check(ate_gt <= ate_c + EVO_MARGIN, "variants",
                  f"{name}: ATE vs GT {ate_gt:.4f} m exceeds the committed "
                  f"{ate_c:.4f} m by more than {EVO_MARGIN} m")


# ---------------------------------------------------------------------------
# phase 9: ssfc and the entry points
# ---------------------------------------------------------------------------


SSFC_FIXTURE = os.path.join(FIXTURES, "ssfc_ref.npz")
# the SegNet's banded launches per scan at 8192 points (band_params, work
# floor 2^20): sa1 (1024 <- 8192) and fp1 (8192 <- 1024) take knn_group;
# sa2 (256 <- 1024) and fp2 (1024 <- 256) the exact path
PER_SCAN_SEGNET = {"knn_group": 2}
# frame 1's classifier on the fixture's flow against JAX's: static masks
# equal on this share of the points, logits within this (float32)
SEG_AGREE, SEG_LOGIT_TOL = 0.999, 1e-3
# poses of two runs of one f32 computation on the card (the CLI's against
# the in-process run; stream against batch under one box; resumed against
# uninterrupted), in metres: the scatters' float32 atomics move the flow
# in its last bits from run to run
RUN_TOL = 1e-3
N_STREAM_F32, N_RESUME = 8, 4
N_RESAMPLE = 4
WEIGHTS = os.path.join("ssf_slam_tpu_torch", "weights")
CLI_CKPTS = ["--ckpt", os.path.join(WEIGHTS, "ssf_r3ft2.npz"),
             "--seg-ckpt", os.path.join(WEIGHTS, "segnet_r3.npz")]


def profiled_ms(fn, n: int = 8) -> tuple[float, float]:
    """(device ms, kernel launches) a call of fn() over n calls, from
    torch.profiler's device-side events (the SegNet's own host time
    outlasts its kernels, so events around it time the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # device-side events only: the aten ops that launched them carry the
    # same time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in kernels) / 1e3 / n,
            sum(e.count for e in kernels) / n)


def seg_model(dev, dtype: str = "bfloat16"):
    """The ssfc classifier with the committed weights (bf16 by default, as
    the JAX CLI builds it)."""
    from ssf_slam_tpu_torch.weights import load_segnet

    return load_segnet(dtype=dtype, device=dev)


def f32_model(dev):
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.weights import load_tflow

    return load_tflow(FlowNetConfig(npoint=N_POINTS, joint_seg=True,
                                    neighbor_backend="banded"), device=dev)


def _pose_diff(got: dict, want: dict) -> tuple[float, float]:
    """Largest |d pose_t| (m) and pose rotation (rad) over the frames."""
    return (float(np.abs(got["pose_t"] - want["pose_t"]).max()),
            float(_rot_angle(got["pose_q"], want["pose_q"]).max()))


def phase_ssfc(frames, dev, smi: str, main_launches: dict,
               main_sps: float) -> None:
    """(a) f32 parity with the JAX fixture and frame 1's classifier; (b)
    the ssfc main path, counters reset just before and read just after;
    (f) the resampled ensemble's members."""
    from ssf_slam_tpu_torch.engine.evaluation import ate_rmse
    from ssf_slam_tpu_torch.engine.fused import (
        run_sequence_fused,
        sequence_box,
        stack_fused_scans,
    )
    from ssf_slam_tpu_torch.models.inference import predict_flow_resampled

    # (a) f32 parity
    n = N_FIXTURE_FRAMES
    with np.load(SSFC_FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    pts = stack_fused_scans(frames[:n], N_POINTS)["points"]
    box = sequence_box(pts, device=dev)
    check(np.array_equal(box[0].cpu().numpy(), ref["box_origin"])
          and np.array_equal(box[1].cpu().numpy(), ref["box_scale"]),
          "ssfc", "the fixture's Morton box differs")
    f32, seg32 = f32_model(dev), seg_model(dev, "float32")
    got = run_sequence_fused(f32, frames[:n], device=dev, box=box,
                             seg_apply=seg32)
    dt = np.abs(got["rel_t"] - ref["rel_t"]).max()
    dr = _rot_angle(got["rel_q"], ref["rel_q"]).max()
    dpt, dpr = _pose_diff(got, ref)
    with torch.inference_mode():
        prev = torch.as_tensor(pts[0], device=dev)[None]
        flow = torch.as_tensor(ref["flow/1"], device=dev)[None]
        logits = seg32(prev, flow)[0].cpu().numpy()
    dl = float(np.abs(logits - ref["logits/1"]).max())
    agree = float(((logits.argmax(-1) == 0) == ref["static/1"]).mean())
    say("ssfc", f"(a) {n} f32 frames vs JAX (ssfc_ref.npz): max |d rel_t| "
        f"{dt:.3g} m, rotation {dr:.3g} rad; |d pose_t| {dpt:.3g} m, "
        f"rotation {dpr:.3g} rad; keyframes "
        f"{got['is_keyframe'].astype(int).tolist()}; frame 1's classifier "
        f"on JAX's flow: logits within {dl:.3g}, static masks agree on "
        f"{agree:.6f} ({int((~ref['static/1']).sum())} moving in JAX)")
    for key in ("rel_t", "pose_t", "pose_q", "odom_t"):
        check(np.isfinite(got[key]).all(), "ssfc", f"non-finite {key}")
    check(dt <= 1e-2 and dpt <= 1e-2, "ssfc",
          f"rel_t / pose_t differ by {dt} / {dpt} m")
    check(dr <= 1e-3 and dpr <= 1e-3, "ssfc",
          f"rotations differ by {dr} / {dpr} rad")
    for key in ("is_keyframe", "n_features"):
        check(np.array_equal(got[key], ref[key]), "ssfc",
              f"{key} {got[key].tolist()} != {ref[key].tolist()}")
    check(agree >= SEG_AGREE and dl <= SEG_LOGIT_TOL, "ssfc",
          f"frame 1's classifier: agreement {agree}, logits {dl}")

    # (b) the ssfc main path
    model, seg = bf16_model(dev, fuse=False), seg_model(dev)
    run_sequence_fused(model, frames[:2], device=dev, seg_apply=seg)
    torch.cuda.synchronize()
    reset_all()
    t0 = time.perf_counter()
    got = run_sequence_fused(model, frames, device=dev, seg_apply=seg)
    secs = time.perf_counter() - t0
    launches = read_all()
    gt = np.stack([f["pose1"][1] for f in frames])
    ate = ate_rmse(got["pose_t"], gt)
    sps = len(frames) / secs
    with torch.inference_mode():
        prev = torch.as_tensor(pts[0], device=dev)[None]
        flow = torch.as_tensor(got["flow"][1][:, :3].astype(np.float32),
                               device=dev)[None]
        seg_dev, seg_launches = profiled_ms(lambda: seg(prev, flow))
        seg_host = cuda_ms(lambda: seg(prev, flow))
    say("ssfc", f"(b) ssfc main path, {len(frames)} frames x {N_POINTS} "
        f"points, bf16: {sps:.2f} scans/s (host clock; phase 4's SSF "
        f"{main_sps:.2f} in this call; {smi}), ATE pose_t {ate:.4f} m, "
        f"odom_t {ate_rmse(got['odom_t'], gt):.4f} m, "
        f"{int(got['is_keyframe'].sum())} keyframes; the SegNet a scan: "
        f"{seg_dev:.3f} ms of device time in {seg_launches:.0f} launches "
        f"(torch.profiler), {seg_host:.3f} ms under cuda_ms (host-bound); "
        f"launches {launches}")
    for key in ("pose_q", "pose_t", "rel_q", "rel_t", "odom_t", "flow"):
        check(np.isfinite(got[key]).all(), "ssfc", f"non-finite {key}")
    for name, base in main_launches.items():
        want = base + PER_SCAN_SEGNET.get(name, 0) * len(frames)
        check(launches[name] == want, "ssfc",
              f"{name} launched {launches[name]} times, expected {want} "
              f"(phase 4's {base} + the SegNet's)")
    check(ate < 0.5, "ssfc", f"ATE {ate} m")

    # (f) the resampled ensemble: how far apart its members are
    pc1, pc2 = (torch.as_tensor(p, device=dev)[None] for p in pts[:2])
    gen = torch.Generator().manual_seed(0)
    perms = torch.stack([torch.randperm(N_POINTS, generator=gen)
                         for _ in range(N_RESAMPLE)])
    with torch.inference_mode():
        members = torch.stack([predict_flow_resampled(
            model, pc1, pc2, perms=p[None])[0, :, :3].float() for p in perms])
        mean = predict_flow_resampled(model, pc1, pc2, perms=perms)
    spread = (members - members[0]).norm(dim=-1)
    say("ssfc", f"(f) predict_flow_resampled, bf16, frame pair (0, 1), "
        f"{N_RESAMPLE} permutations: member end-point distance from member "
        f"0 max {float(spread.max()):.4g} m, mean "
        f"{float(spread.mean()):.4g} m; members equal: "
        f"{[bool(torch.equal(m, members[0])) for m in members[1:]]}")
    check(bool(torch.isfinite(mean).all()), "ssfc",
          "non-finite resampled flow")


def _cli(args: list) -> str:
    """``python -m ssf_slam_tpu_torch.cli`` in a subprocess from the
    checkout's root; fails on a nonzero exit; returns its standard output."""
    cmd = [sys.executable, "-m", "ssf_slam_tpu_torch.cli", *args]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, "entry", f"{' '.join(args[:2])} exit "
          f"{proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def phase_cli(dev) -> None:
    """(d) the command line in subprocesses: run ssfc (f32 TFlow, as the
    CLI builds the classifier: bf16) against the same build in process;
    evaluate noseg,ssfc; run --stream at depth 1 and 2."""
    import tempfile

    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.engine.evaluation import read_tum
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused

    with tempfile.TemporaryDirectory() as tmp:
        tum = os.path.join(tmp, "ssfc.tum")
        out = _cli(["run", "--variant", "ssfc", "--synthetic", "--frames",
                    str(N_FIXTURE_FRAMES), "--net-dtype", "float32",
                    *CLI_CKPTS, "--out", tum])
        say("entry", "(d) cli run --variant ssfc: " + " | ".join(
            out.strip().splitlines()))
        frames = generate_sequence(n_frames=N_FIXTURE_FRAMES,
                                   n_points=N_POINTS, seed=0, noise=0.004,
                                   n_moving=4)
        want = run_sequence_fused(f32_model(dev), frames, device=dev,
                                  seg_apply=seg_model(dev))
        _, pos, quat = read_tum(tum)
        dp = float(np.abs(pos - want["pose_t"]).max())
        dq = float(_rot_angle(quat, want["pose_q"]).max())
        say("entry", f"(d) its TUM file vs the same build in process: "
            f"|d pose_t| {dp:.3g} m, rotation {dq:.3g} rad")
        check(len(pos) == N_FIXTURE_FRAMES and dp <= RUN_TOL, "entry",
              f"cli ssfc poses differ by {dp} m")

        res = os.path.join(tmp, "res")
        out = _cli(["evaluate", "--synthetic", "--frames",
                    str(N_FIXTURE_FRAMES), "--variants", "noseg,ssfc",
                    *CLI_CKPTS, "--out-dir", res])
        table = [line for line in out.splitlines() if line.startswith("|")]
        for line in table:
            say("entry", f"(d) cli evaluate: {line}")
        for v in ("SEG", "NOSEG", "SSFC"):
            for ext in ("tum", "kitti"):
                path = os.path.join(res, f"00_{v}.{ext}")
                check(os.path.exists(path), "entry", f"no {path}")
        check(any(line.startswith("| ssfc |") for line in table)
              and any(line.startswith("| noseg |") for line in table),
              "entry", "cli evaluate printed no table")

        for depth in (1, 2):
            out = _cli(["run", "--variant", "ssf", "--stream", "--synthetic",
                        "--frames", str(N_FRAMES), "--pipeline-depth",
                        str(depth), CLI_CKPTS[0], CLI_CKPTS[1], "--out",
                        os.path.join(tmp, f"stream{depth}.tum")])
            lines = [line for line in out.splitlines()
                     if line.startswith(("rate ", "streamed "))]
            say("entry", f"(d) cli run --stream --pipeline-depth {depth}: "
                + " | ".join(lines))
            check(len(lines) == 2 and "completion latency mean" in lines[1],
                  "entry", f"--stream depth {depth} printed {out!r}")


def phase_stream(frames, dev, smi: str) -> None:
    """(e) StreamingRunner: f32 against the batch runner under its box;
    bf16 at depth 1 and 2 over the 32 frames; a checkpoint after 4 of 8 f32
    scans, resumed in a fresh runner, against the uninterrupted run."""
    import tempfile

    from ssf_slam_tpu_torch.config import PipelineConfig, Variant
    from ssf_slam_tpu_torch.engine.checkpoint import (
        load_slam_state,
        save_slam_state,
    )
    from ssf_slam_tpu_torch.engine.evaluation import read_tum
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused
    from ssf_slam_tpu_torch.engine.streaming import StreamingRunner

    cfg = PipelineConfig(variant=Variant.SSF)
    f32 = f32_model(dev)
    fx = frames[:N_STREAM_F32]
    with tempfile.TemporaryDirectory() as tmp:
        whole = StreamingRunner(f32, cfg, pipeline_depth=2, device=dev,
                                tum_path=os.path.join(tmp, "whole.tum"))
        whole.run(iter(fx))
        _, pos, quat = read_tum(os.path.join(tmp, "whole.tum"))
        stream = dict(pose_t=pos, pose_q=quat)
        batch = run_sequence_fused(f32, fx, cfg, device=dev, box=whole.box)
        dp, dq = _pose_diff(stream, batch)
        say("stream", f"(e) StreamingRunner f32, {len(fx)} frames, depth 2, "
            f"vs run_sequence_fused under its box: |d pose_t| {dp:.3g} m, "
            f"rotation {dq:.3g} rad")
        check(dp <= RUN_TOL, "stream", f"stream vs batch: {dp} m")

        first = StreamingRunner(f32, cfg, pipeline_depth=1, device=dev,
                                tum_path=os.path.join(tmp, "a.tum"))
        first.run(iter(fx[:N_RESUME]))
        ckpt = os.path.join(tmp, "state.npz")
        save_slam_state(ckpt, first.final_state, N_RESUME)
        state, index = load_slam_state(ckpt, cfg, dev)
        rest = StreamingRunner(f32, cfg, pipeline_depth=1, device=dev,
                               box=first.box,
                               tum_path=os.path.join(tmp, "b.tum"))
        rest.run(iter(fx[index:]), state=state, prev=fx[index - 1])
        parts = [read_tum(os.path.join(tmp, f"{x}.tum")) for x in "ab"]
        resumed = dict(pose_t=np.concatenate([p[1] for p in parts]),
                       pose_q=np.concatenate([p[2] for p in parts]))
        dp, dq = _pose_diff(resumed, stream)
        say("stream", f"(e) saved after {N_RESUME} of {len(fx)} f32 scans "
            f"({os.path.getsize(ckpt) / 2**20:.1f} MiB), resumed in a fresh "
            f"runner: |d pose_t| {dp:.3g} m, rotation {dq:.3g} rad vs the "
            f"uninterrupted run")
        check(len(resumed["pose_t"]) == len(fx) and dp <= RUN_TOL, "stream",
              f"resumed vs uninterrupted: {dp} m")

    # depth 1 and 2 in turns (1, 2, 2, 1): the host clock spreads by
    # tens of percent within a call
    model = bf16_model(dev, fuse=False)
    for depth in (1, 2, 2, 1):
        runner = StreamingRunner(model, cfg, pipeline_depth=depth,
                                 device=dev)
        st = runner.run(iter(frames))
        say("stream", f"(e) StreamingRunner bf16, {st['n_scans']} frames, "
            f"depth {depth}: {st['hz']:.2f} Hz, completion latency mean "
            f"{st['latency_ms_mean']:.2f} ms, p95 {st['latency_ms_p95']:.2f}"
            f" ms, dispatch mean {st['dispatch_ms_mean']:.2f} ms, p95 "
            f"{st['dispatch_ms_p95']:.2f} ms ({smi})")
        check(st["n_scans"] == len(frames) and np.isfinite(st["hz"]),
              "stream", f"depth {depth}: {st}")


# ---------------------------------------------------------------------------
# phase 10: many sequences on one card, and SegNet training
# ---------------------------------------------------------------------------

BATCH_FRAMES, BATCH_REPEATS = 8, 3
SEG_TRAIN_FIXTURE = os.path.join(FIXTURES, "segnet_train_small_ref.npz")
SEG_STEPS, SEG_LR, SEG_NOISE = 8, 1e-3, 0.05


def _members_vs_alone(got: dict, alone: list) -> tuple[float, float, bool]:
    """(max |d pose_t|, max |d odom_t|, is_keyframe equal) of a batched
    run's members against the same members run alone."""
    dp = max(float(np.abs(got["pose_t"][b] - a["pose_t"]).max())
             for b, a in enumerate(alone))
    do = max(float(np.abs(got["odom_t"][b] - a["odom_t"]).max())
             for b, a in enumerate(alone))
    kf = all(np.array_equal(got["is_keyframe"][b], a["is_keyframe"])
             for b, a in enumerate(alone))
    return dp, do, kf


def phase_batched(dev, smi: str) -> dict:
    """(a) the batched runs against their members alone; (b) the
    batch-economics table. Returns the kernel launches of the largest
    batch's run."""
    from ssf_slam_tpu_torch.config import PipelineConfig, Variant
    from ssf_slam_tpu_torch.engine.fused import (
        run_sequence_fused,
        sequence_box,
        stack_fused_scans,
    )
    from ssf_slam_tpu_torch.engine.pipeline import run_sequence
    from ssf_slam_tpu_torch.parallel import batch_economics as be
    from ssf_slam_tpu_torch.parallel.mesh import (
        run_sequences_batched,
        run_sequences_fused_batched,
    )
    from ssf_slam_tpu_torch.weights import load_tflow

    cfg, net = be.economics_configs(dtype="float32")
    seqs = be.make_sequences(max(be.BATCHES))
    pair = [s[:BATCH_FRAMES] for s in seqs[:2]]
    box = sequence_box(np.stack([stack_fused_scans(s, N_POINTS)["points"]
                                 for s in pair]), device=dev)
    f32 = load_tflow(net, device=dev)
    _, got = run_sequences_fused_batched(f32, pair, cfg, device=dev, box=box)
    alone = [run_sequence_fused(f32, s, cfg, device=dev, box=box)
             for s in pair]
    dp, do, kf = _members_vs_alone(got, alone)
    say("batched", f"(a) run_sequences_fused_batched f32, B=2 x "
        f"{BATCH_FRAMES} frames x {N_POINTS} points, each member against "
        f"run_sequence_fused alone under the shared box: |d pose_t| "
        f"{dp:.3g} m, |d odom_t| {do:.3g} m, keyframes equal {kf}")
    check(dp <= LOOP_TOL and do <= LOOP_TOL and kf, "batched",
          f"fused members differ from alone: {dp}, {do}, keyframes {kf}")
    check(np.isfinite(got["flow"]).all(), "batched", "non-finite flow")
    seg = PipelineConfig(variant=Variant.SEG)
    _, got = run_sequences_batched(pair, seg, device=dev)
    alone = [run_sequence(s, seg, device=dev)[1] for s in pair]
    dp, do, kf = _members_vs_alone(got, alone)
    say("batched", f"(a) run_sequences_batched SEG (ground-truth flow), "
        f"B=2: |d pose_t| {dp:.3g} m, |d odom_t| {do:.3g} m against "
        f"run_sequence alone, keyframes equal {kf}")
    check(dp <= LOOP_TOL and do <= LOOP_TOL and kf, "batched",
          f"SEG members differ from alone: {dp}, {do}, keyframes {kf}")

    cfg, net = be.economics_configs()
    model = load_tflow(net, device=dev)
    rows = be.measure(model, seqs, cfg, be.BATCHES, BATCH_REPEATS, dev)
    n_frames = len(seqs[0])
    for r in rows:
        say("batched", f"(b) {be.row_line(r)}; repeats "
            + ", ".join(f"{a:.2f}" for a in r["agg"]) + f"; launches "
            f"{r['launches']} ({smi})")
        check(r["finite"] and max(r["ate"]) < 0.5, "batched",
              f"B={r['b']}: ATE {r['ate']}")
        for name in PER_SCAN:
            want = PER_SCAN[name] * n_frames + PER_TOWER[name]
            check(r["launches"].get(name, 0) == want, "batched",
                  f"B={r['b']}: {name} launched "
                  f"{r['launches'].get(name, 0)} times, expected {want}")
        check(set(r["launches"]) <= set(PER_SCAN), "batched",
              f"B={r['b']}: other kernels launched: {r['launches']}")
    for line in be.table(rows).splitlines():
        say("batched", f"(b) {line}")
    last = rows[-1]
    say("batched", f"(b) the kernels at B={last['b']}, launches a scan: "
        + ", ".join(f"{k} {v / (last['b'] * n_frames):.4g}"
                    for k, v in last["launches"].items()))
    return last["launches"]


def _seg_train_batch():
    """The batch and flow noise of tests/test_torch_segnet_train.py."""
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    frames = generate_sequence(n_frames=2, n_points=1024, seed=5,
                               noise=0.004, n_moving=6)
    batch = dict(
        xyz=np.stack([f["pos1"] for f in frames]).astype(np.float32),
        flow=np.stack([f["gt"] for f in frames]).astype(np.float32),
        labels=np.stack([f["s_fg_mask"] > 0.5 for f in frames]).astype(
            np.int64),
        mask=np.stack([f["mask1"] for f in frames]).astype(np.float32))
    noise = (0.03 * np.random.default_rng(11).normal(
        size=batch["flow"].shape)).astype(np.float32)
    return batch, noise


def phase_segnet_train(dev, smi: str) -> None:
    """(c) SegNet training on the card."""
    from ssf_slam_tpu_torch.data.carla import compute_label_weights
    from ssf_slam_tpu_torch.models.layers import init_flax
    from ssf_slam_tpu_torch.models.segnet import SegNet
    from ssf_slam_tpu_torch.train import train_segnet as ts
    from ssf_slam_tpu_torch.train.trainer import Adam
    from ssf_slam_tpu_torch.weights import (
        SEGNET_NPZ,
        from_flax,
        load_npz,
        to_flax,
    )

    train, _ = ts.build_corpus(1, TRAIN_BATCH)
    lw = compute_label_weights(train)
    class_w = torch.as_tensor(lw, dtype=torch.float32, device=dev)
    batch = next(ts.batches(train, TRAIN_BATCH, 0, dev))
    model = init_flax(SegNet(n_classes=2, dtype="bfloat16"),
                      torch.Generator().manual_seed(0)).to(dev)
    tx = Adam(SEG_LR)
    opt = tx.init(dict(model.named_parameters()))
    gen = torch.Generator(device=dev).manual_seed(7)
    noises = [ts.flow_noise(batch["flow"].shape, SEG_NOISE, gen, dev)
              for _ in range(SEG_STEPS + 1)]
    ts.train_step(model, tx, opt, batch, noises[0], class_w)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all()
    t0 = time.perf_counter()
    losses = [ts.train_step(model, tx, opt, batch, n, class_w)
              for n in noises[1:]]
    losses = [float(x) for x in losses]  # ends on the host
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in read_all().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ev = {k: float(v) for k, v in ts.eval_metrics(
        model, batch, torch.zeros_like(batch["flow"])).items()}
    say("segtrain", f"(c) SegNet bf16, {TRAIN_BATCH} x {N_POINTS} points, "
        f"one fixed batch, lr {SEG_LR}, flow noise U(0, {SEG_NOISE}): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} over {SEG_STEPS} steps "
        f"({[round(x, 4) for x in losses]}), {SEG_STEPS / dt:.2f} steps/s "
        f"(host clock), peak memory {peak:.2f} GiB, kernel launches "
        f"{launches}; on the batch: {ev} ({smi})")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], "segtrain",
          f"the fixed-batch loss did not fall: {losses}")
    check(not launches, "segtrain", f"hand-written kernels ran: {launches}")

    # the f32 step of the small SegNet against JAX's
    with np.load(SEG_TRAIN_FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    host, noise = _seg_train_batch()
    b = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    model = SegNet(n_classes=2, sa_npoints=(256, 64))
    model.load_state_dict(from_flax(load_npz(SEGNET_NPZ)), strict=True)
    model = model.to(dev).train()
    params = dict(model.named_parameters())
    logits = model(b["xyz"], b["flow"] + torch.as_tensor(noise, device=dev))
    loss = ts.weighted_ce(logits, b["labels"], b["mask"],
                          torch.as_tensor(ref["label_weights"], device=dev))
    grads = to_flax(model, dict(zip(params, torch.autograd.grad(
        loss, list(params.values())))))
    d_loss = abs(loss.item() - float(ref["loss"])) / abs(float(ref["loss"]))
    want = {k: np.linalg.norm(ref[f"grad/{k}"].astype(np.float64))
            for k in grads}
    err = _leaf_errors({k: np.linalg.norm(g) for k, g in grads.items()},
                       want)
    worst = max(err, key=err.get)
    say("segtrain", f"(c) f32 step of the small SegNet vs the JAX fixture: "
        f"loss {loss.item():.6f} vs {float(ref['loss']):.6f} ({d_loss:.2e} "
        f"relative); gradient norms: {sum(e > 1e-3 for e in err.values())} "
        f"of {len(err)} beyond 1e-3, worst {worst} {err[worst]:.2e}")
    check(d_loss <= 1e-4, "segtrain", f"loss differs by {d_loss:.2e}")
    check(err[worst] <= 1e-3, "segtrain",
          f"gradient norm of {worst} differs by {err[worst]:.2e}")


# ---------------------------------------------------------------------------
# phase 11: sharding over torch.distributed at world size 1, and Town02
# ---------------------------------------------------------------------------

SHARD_FRAMES, SHARD_MARGIN = 8, 100.0
# bf16 sharded runs against BF16_ALONE runs alone: within BF16_SPREADS
# times the larger of the alone runs' spread and LOOP_TOL (readings, PERF.md
# §6: sharded against alone 4.08e-4 to 1.16e-3 m, alone against alone
# 6.73e-4 to 1.22e-3 m)
BF16_ALONE, BF16_SPREADS = 3, 3.0
POINTSHARD = dict(k=16, c=99, halo=512)
TOWN02_FRAMES = 6
PLAIN_KEYS = ("pos1", "pos2", "gt", "mask1", "s_fg_mask")


def write_planar_map(path: str, seed: int = 0, spacing: float = 0.5) -> int:
    """A KITTI .bin (x, y, z, intensity float32 rows) inside the Town02
    map's extent (x in [-9, 195], y in [-308, -103], z = -2.5): streets
    8 m wide every 40 m. A generated map, not Town02."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(-9.0, 195.0, spacing),
                         np.arange(-308.0, -103.0, spacing), indexing="ij")
    road = ((np.abs((gx + 9.0) % 40.0 - 20.0) < 4.0)
            | (np.abs((gy + 308.0) % 40.0 - 20.0) < 4.0))
    x = gx[road] + rng.uniform(-0.1, 0.1, road.sum())
    y = gy[road] + rng.uniform(-0.1, 0.1, road.sum())
    rows = np.stack([x, y, np.full_like(x, -2.5), rng.uniform(0, 1, x.size)],
                    1).astype(np.float32)
    rows.tofile(path)
    return len(rows)


def phase_sharded(frames, dev, smi: str) -> dict:
    """(a) the sharded serving, streaming and training paths at world size
    1 over NCCL on the card. Returns the launches of each path's run."""
    import tempfile

    import torch.distributed as dist

    from ssf_slam_tpu_torch.config import (FlowNetConfig, LossConfig,
                                           PipelineConfig, TrainConfig)
    from ssf_slam_tpu_torch.data.carla import compute_label_weights
    from ssf_slam_tpu_torch.data.ssfb import SsfbStripe, write_ssfb
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused
    from ssf_slam_tpu_torch.parallel.mesh import (
        anchored_box,
        make_mesh,
        make_sharded_train_step,
        run_sequences_sharded,
        run_sequences_sharded_streaming,
        shard_batch,
    )
    from ssf_slam_tpu_torch.train.trainer import (
        create_train_state,
        make_train_step,
        to_device,
    )
    from ssf_slam_tpu_torch.weights import load_tflow, to_flax

    mesh = make_mesh(1, device="cuda")
    say("sharded", f"mesh: rank {mesh.rank} of {mesh.world_size}, backend "
        f"{dist.get_backend()}, device {mesh.device}")
    check(dist.get_backend() == "nccl" and mesh.device.type == "cuda",
          "sharded", f"backend {dist.get_backend()} on {mesh.device}")
    seq = frames[:SHARD_FRAMES]
    cfg = PipelineConfig()
    model = bf16_model(dev, fuse=False)
    f32 = load_tflow(FlowNetConfig(npoint=N_POINTS, joint_seg=True,
                                   dtype="float32",
                                   neighbor_backend="banded"), device=dev)
    run_sequences_sharded([seq[:2]], cfg, mesh, model=model)  # warm-up
    torch.cuda.synchronize()
    reset_all()
    t0 = time.perf_counter()
    states, got = run_sequences_sharded([seq], cfg, mesh, model=model)
    dt = time.perf_counter() - t0
    serve = {k: v for k, v in read_all().items() if v}
    # bf16 runs of one step differ from run to run: the scatters' float32
    # atomics sum in another order each time, and bf16 rounds that up
    # (4e-4 to 1.2e-3 m over 8 frames). So bf16 is held against every one
    # of BF16_ALONE runs alone within BF16_SPREADS times the larger of
    # their own spread and LOOP_TOL, and f32 (runs of one step within
    # ~1e-5 m) within LOOP_TOL
    alone = [run_sequence_fused(model, seq, cfg, device=dev)
             for _ in range(BF16_ALONE)]
    spread = max(float(np.abs(a["pose_t"] - b["pose_t"]).max())
                 for i, a in enumerate(alone) for b in alone[i + 1:])
    bf16_tol = BF16_SPREADS * max(spread, LOOP_TOL)
    pairs = [_members_vs_alone(got, [a]) for a in alone]
    dp, do = max(p[0] for p in pairs), max(p[1] for p in pairs)
    kf = all(p[2] for p in pairs)
    say("sharded", f"(a) run_sequences_sharded, SSF bf16, {SHARD_FRAMES} x "
        f"{N_POINTS} points: {SHARD_FRAMES / dt:.2f} scans/s (host clock), "
        f"against {BF16_ALONE} run_sequence_fused runs under the same box "
        f"|d pose_t| {dp:.3g} m, |d odom_t| {do:.3g} m, keyframes equal "
        f"{kf} (the alone runs apart by up to {spread:.3g} m; bound "
        f"{bf16_tol:.3g} m); launches {serve}")
    check(len(states) == 1 and got["pose_t"].shape == (1, SHARD_FRAMES, 3)
          and np.isfinite(got["pose_t"]).all(), "sharded",
          f"outputs {got['pose_t'].shape}")
    check(dp <= bf16_tol and do <= bf16_tol, "sharded",
          f"bf16 sharded run differs from alone: {dp}, {do} m against "
          f"{bf16_tol} m")
    for name in PER_SCAN:
        want = PER_SCAN[name] * SHARD_FRAMES + PER_TOWER[name]
        check(serve.get(name, 0) == want, "sharded",
              f"{name} launched {serve.get(name, 0)} times, expected {want}")
    _, got32 = run_sequences_sharded([seq], cfg, mesh, model=f32)
    alone32 = run_sequence_fused(f32, seq, cfg, device=dev)
    dp, do, kf = _members_vs_alone(got32, [alone32])
    say("sharded", f"(a) run_sequences_sharded f32 against "
        f"run_sequence_fused under the same box: |d pose_t| {dp:.3g} m, "
        f"|d odom_t| {do:.3g} m, keyframes equal {kf}")
    check(dp <= LOOP_TOL and do <= LOOP_TOL and kf, "sharded",
          f"sharded run differs from alone: {dp}, {do}, keyframes {kf}")

    # streaming: the rate in bf16, the poses against the batch run under
    # the stream's box in f32
    box = anchored_box(seq[0]["pos1"][:N_POINTS], SHARD_MARGIN, dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "seq.ssfb")
        write_ssfb(seq, path)
        for label, net in (("bf16", model), ("f32", f32)):
            _, anchored = run_sequences_sharded([seq], cfg, mesh, model=net,
                                                box=box)
            for depth in (1, 2):
                stripe = SsfbStripe([path])
                try:
                    _, streamed, stats = run_sequences_sharded_streaming(
                        stripe.batches(), cfg, mesh, net,
                        box_margin=SHARD_MARGIN, pipeline_depth=depth)
                finally:
                    stripe.close()
                d = float(np.abs(streamed["pose_t"]
                                 - anchored["pose_t"]).max())
                say("sharded", f"(a) run_sequences_sharded_streaming {label}"
                    f" depth {depth}: hz_per_seq {stats['hz_per_seq']:.2f}, "
                    f"latency mean {stats['latency_ms_mean']:.2f} ms p95 "
                    f"{stats['latency_ms_p95']:.2f} ms, step "
                    f"{stats['step_ms_mean']:.2f} ms; |d pose_t| against the "
                    f"batch run under the stream's box {d:.3g} m ({smi})")
                check(stats["n_scans"] == SHARD_FRAMES
                      and np.isfinite(streamed["pose_t"]).all(), "sharded",
                      f"depth {depth}: {stats['n_scans']} scans")
                tol = LOOP_TOL if label == "f32" else bf16_tol
                check(d <= tol, "sharded",
                      f"{label} depth {depth}: |d pose_t| {d} against {tol}")
    del f32

    # one f32 train step, sharded and in one process, on the first two
    # bench pairs
    net = FlowNetConfig(npoint=N_POINTS, joint_seg=True, dtype="float32",
                        neighbor_backend="banded")
    lw = compute_label_weights(seq[:2])
    batch = {k: np.stack([f[k] for f in seq[:2]]).astype(np.float32)
             for k in PLAIN_KEYS}
    tcfg = TrainConfig(batch_size=2)
    loss_cfg = LossConfig(seg_class_weights=(float(lw[0]), float(lw[1])))
    runs = {}
    for name in ("one", "sharded"):
        m = load_tflow(net, device=dev).train()
        state, tx = create_train_state(m, tcfg)
        if name == "sharded":
            step = make_sharded_train_step(m, tx, mesh, tcfg, loss_cfg)
            torch.cuda.synchronize()
            reset_all()
            state, met = step(state, shard_batch(batch, mesh))
            torch.cuda.synchronize()
            train = {k: v for k, v in read_all().items() if v}
        else:
            step = make_train_step(m, tx, tcfg, loss_cfg)
            state, met = step(state, to_device(batch, dev))
        runs[name] = (float(met["loss"]), to_flax(m))
    (l1, p1), (l2, p2) = runs["one"], runs["sharded"]
    d_loss = abs(l2 - l1) / abs(l1)
    diffs = np.concatenate([np.abs(p2[k] - p1[k]).reshape(-1) for k in p1
                            if k.startswith("params/")])
    stat_err = max(float(np.abs(p2[k] - p1[k]).max() / (np.abs(p1[k]).max()
                                                         + 1e-6))
                   for k in p1 if k.startswith("batch_stats/"))
    exact = float((diffs <= 1e-6).mean())
    say("sharded", f"(a) make_sharded_train_step f32, 2 x {N_POINTS} "
        f"points: loss {l2:.6f} against make_train_step's {l1:.6f} "
        f"({d_loss:.2e} relative); parameters after the step within 1e-6 "
        f"for {exact:.6f} of the elements, max {diffs.max():.3g} (Adam's "
        f"first step is lr g / (|g| + eps): 2 lr where a gradient's sign is "
        f"rounding's); batch statistics within {stat_err:.2e} relative; "
        f"launches {train}")
    check(d_loss <= 1e-5, "sharded", f"loss differs by {d_loss:.2e}")
    check(exact >= 0.999 and diffs.max() <= 2.5 * tcfg.lr and
          stat_err <= 1e-4, "sharded",
          f"parameters {exact} / {diffs.max()}, statistics {stat_err}")
    check(train.get("scatter_add", 0) > 0 and train.get("knn_group", 0) > 0,
          "sharded", f"the train step's kernels: {train}")
    return dict(serve=serve, train=train)


def phase_pointshard(dev, smi: str) -> dict:
    """(b) pointsharded_knn_group on the banded backend at world size 1
    (both halo flanks wrap) at 8192 x 8192: the knn_group kernel launched,
    recall against pointshard_reference, grouped rows exact copies, and the
    kernel's output on the extended target equal to its plain version's."""
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.ops.neighbors import (
        cloud_box,
        morton_sort,
        nn_knn_group,
    )
    from ssf_slam_tpu_torch.parallel.mesh import make_mesh
    from ssf_slam_tpu_torch.parallel.pointshard import (
        pointshard_reference,
        pointsharded_knn_group,
    )

    mesh = make_mesh(1, device="cuda")
    k, c, halo = POINTSHARD["k"], POINTSHARD["c"], POINTSHARD["halo"]
    fr = generate_sequence(n_frames=2, n_points=N_POINTS, seed=0,
                           n_moving=4, radius=30.0)[0]
    q = torch.as_tensor(np.asarray(fr["pos1"], np.float32), device=dev)
    feats = torch.as_tensor(np.random.default_rng(0).normal(
        size=(N_POINTS, c)).astype(np.float32), device=dev)

    def run():
        return pointsharded_knn_group(q, q, feats, k, mesh, halo=halo,
                                      backend="banded")

    run()  # warm-up
    torch.cuda.synchronize()
    reset_all()
    d, idx, grouped = run()
    torch.cuda.synchronize()
    launches = {kk: v for kk, v in read_all().items() if v}
    ms = cuda_ms(run)
    _, i_ref, _ = pointshard_reference(q, q, feats, k, device=dev)
    idx_np, ref_np = idx.cpu().numpy(), i_ref.cpu().numpy()
    hits = sum(len(set(idx_np[i]) & set(ref_np[i]))
               for i in range(0, N_POINTS, 4))
    recall = hits / (len(range(0, N_POINTS, 4)) * k)
    box = cloud_box(q[None], q[None])
    q_sorted, perm = morton_sort(q[None], box=box)
    f_sorted = feats[perm[0]]
    copies = bool(torch.equal(grouped, f_sorted[idx.long()]))
    # the kernel against its plain version on the same extended target
    t = q_sorted[0]
    ext = torch.cat([torch.full((halo, 3), -1e6, device=dev), t,
                     torch.full((halo, 3), 1e6, device=dev)])
    f_ext = torch.cat([f_sorted[-halo:], f_sorted, f_sorted[:halo]])
    i_k, g_k, _, _ = nn_knn_group(t[None], ext[None], f_ext[None], k,
                                  backend="banded", box=box)
    cpu_box = (box[0].cpu(), box[1].cpu())
    i_p, g_p, _, _ = nn_knn_group(t[None].cpu(), ext[None].cpu(),
                                  f_ext[None].cpu(), k, backend="banded",
                                  box=cpu_box)
    same = bool(torch.equal(i_k.cpu(), i_p) and torch.equal(g_k.cpu(), g_p))
    inv = torch.argsort(perm[0])
    via = torch.clamp(i_k[0].long() - halo, 0, N_POINTS - 1)[inv]
    same_path = bool(torch.equal(via.to(idx.dtype), idx))
    say("pointshard", f"(b) pointsharded_knn_group banded, world size 1, "
        f"{N_POINTS} x {N_POINTS}, k {k}, C {c}, halo {halo}: recall "
        f"{recall:.4f} against the one-device oracle (every query is rank "
        f"0's), grouped rows exact copies {copies}, the kernel on the "
        f"extended target equal to its plain version {same}, the sharded "
        f"result its translation {same_path}; {ms:.3f} ms a call (events, "
        f"host work included); launches {launches} ({smi})")
    check(launches.get("knn_group", 0) > 0, "pointshard",
          f"knn_group not launched: {launches}")
    check(recall > 0.9, "pointshard", f"recall {recall}")
    check(copies and same and same_path, "pointshard",
          f"copies {copies}, plain {same}, translation {same_path}")
    check(torch.isfinite(d).all().item(), "pointshard", "non-finite sqdist")
    return launches


def phase_town02(dev, smi: str) -> None:
    """(c) the Town02 code on a generated planar map: make_frames with 4
    vehicles and structures, then eval_town02 at 8192 points in bf16."""
    import tempfile

    from ssf_slam_tpu_torch.data import town02
    from ssf_slam_tpu_torch.engine import eval_town02
    from ssf_slam_tpu_torch.weights import DEFAULT_NPZ

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "planar-map.bin")
        n_rows = write_planar_map(path)
        saved, town02.MAP_BIN = town02.MAP_BIN, path
        try:
            raw, poses = town02.make_frames(TOWN02_FRAMES, n_vehicles=4,
                                            structures=True)
            movers = sum(int(f["s_fg_mask"].sum()) for f in raw)
            reset_all()
            t0 = time.perf_counter()
            agg = eval_town02.evaluate(eval_town02.parse_args([
                "--ckpt", DEFAULT_NPZ, "--frames", str(TOWN02_FRAMES),
                "--vehicles", "4", "--structures", "--n-points",
                str(N_POINTS), "--device", "cuda"]))
            dt = time.perf_counter() - t0
            launches = {k: v for k, v in read_all().items() if v}
        finally:
            town02.MAP_BIN = saved
    say("town02", f"(c) generated map, not Town02 ({n_rows} map rows): "
        f"make_frames {len(raw)} pairs, {movers} mover points; eval_town02 "
        f"bf16, {N_POINTS} points: ATE {agg['ate_m']:.4f} m, EPE3D "
        f"{agg['epe3d']:.4f} m, Acc3DR {agg['acc3d_relax']:.4f}, moving IoU "
        f"{agg.get('iou_moving', float('nan')):.4f}, {dt:.1f} s; launches "
        f"{launches} ({smi})")
    check(len(raw) == TOWN02_FRAMES and len(poses) == TOWN02_FRAMES + 1
          and movers > 0, "town02", f"{len(raw)} pairs, {movers} movers")
    check(all(np.isfinite(v) for v in agg.values()), "town02",
          f"non-finite metrics {agg}")
    check(launches.get("knn_group", 0) > 0, "town02",
          f"the serving kernels did not run: {launches}")


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
    smi = phase_build()
    frames = bench_frames()
    records = phase_kernels(frames, dev)
    phase_shapes(frames, dev)
    phase_f32(frames, dev)
    launches, e2e = phase_main(frames, dev, fuse=False)
    launches_fused, e2e_fused = phase_main(frames, dev, fuse=True)
    scan = records["cost_attention"]["per_scan"]
    say("main-fused", f"cost_attention per scan (its two launches, alone, "
        f"phase 2): {scan['alone']:.4f} ms, bound {scan['bound']:.4f} ms, "
        f"share {scan['bound'] / scan['alone']:.3f}")
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
        device = {fuse: phase_profile(frames, dev, 1e3 / med[fuse],
                                      profile_dir, fuse=fuse)
                  for fuse in (False, True)}
        say("profile", f"device time per scan: fuse_attention off "
            f"{device[False]:.3f} ms, on {device[True]:.3f} ms")
    launches_entry = phase_entry(frames, dev)
    phase_loop(dev)
    phase_overflow(dev)
    launches_train = phase_train(dev, profile_dir)
    phase_variants(frames, dev, smi, launches)
    phase_ssfc(frames, dev, smi, launches, e2e["scans_per_s"])
    phase_cli(dev)
    phase_stream(frames, dev, smi)
    phase_batched(dev, smi)
    phase_segnet_train(dev, smi)
    sharded = phase_sharded(frames, dev, smi)
    pointshard = phase_pointshard(dev, smi)
    phase_town02(dev, smi)
    import torch.distributed as dist

    dist.destroy_process_group()
    say("sharded", "launches of the sharded paths: serving "
        f"{sharded['serve']}, training {sharded['train']}, pointshard "
        f"{pointshard}")
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
