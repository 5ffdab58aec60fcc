"""Chip smoke test of the PyTorch + CUDA port (``ssf_slam_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package. Phases, each
printing its own line and failing loudly:

1. build: compile every CUDA source of the port with nvcc (all at once)
   and print the card's name and power limit;
2. kernels: each of the five kernels at its largest main-path shape, on
   Morton-sorted clouds of the bench sequence (the cost attention on the
   level-0 cost volume's own inputs, with the folded weightnet of the
   committed flow0_r), held against its plain PyTorch version on the card
   (exact: idx, sqdist, grouped, regroup; knn_idw's bf16 output to one bf16
   rounding step, 2^-8 relative + 1e-6 absolute; scatter_softmax_sum to
   1e-5 relative + 1e-5 absolute for the atomics' run-to-run order;
   cost_attention as stated and justified at COST_ATTENTION_TOL), and
   timed with CUDA
   events beside the plain version, one PyTorch library call where one
   computes the same function, and the bound of the card;
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
   with two cost_attention launches per scan.

With ``--profile DIR`` it then runs phases 5 and 4 three times more in
turns (so that each setting runs first as often as the other) and prints
their scans/s side by side, traces 8 scans of each main path with
torch.profiler, writes device time by kernel to DIR/profile_<name>.txt and
counts the host syncs per scan by the port's source lines.

The last two lines of standard output are the kernels JSON object and the
result JSON object; the card's name and power limit come before them.
Exits nonzero, printing no result, when CUDA is absent or any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_POINTS, N_FRAMES, N_FIXTURE_FRAMES = 8192, 32, 8
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, non-tensor
# f32, bf16 tensor cores
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
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


def bound(nbytes: float, flops: float,
          peak_ops: float = PEAK_F32) -> tuple[float, str]:
    """The least time (ms) for the work and what sets it: bytes over the
    memory rate or operations over ``peak_ops`` (f32 CUDA cores for the
    banded kernels, whose work is not matmul; bf16 tensor cores for the
    cost attention's products)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build() -> str:
    from ssf_slam_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    reports = cuda_build.build_all(verbose=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"{name}: {line.strip()}")
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
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
    from ssf_slam_tpu_torch.engine.fused import sequence_box, stack_fused_scans
    from ssf_slam_tpu_torch.ops import banded
    from ssf_slam_tpu_torch.ops import neighbors as nb

    scans = stack_fused_scans(frames, N_POINTS)
    box = sequence_box(scans["points"], device=dev)
    pc1, _ = nb.morton_sort(torch.as_tensor(scans["points"][0:1],
                                            device=dev), box=box)
    pc2, _ = nb.morton_sort(torch.as_tensor(scans["points"][1:2],
                                            device=dev), box=box)
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
        library_ms=None,
        bound=bound((n + m) * 3 * f32 + m * c * f32 + n * k * (2 * 4)
                    + n * k * c * f32, n * wb * 8))
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
        library_ms=None,
        bound=bound((n + m) * 3 * f32 + m * c * bf16 + n * c * bf16
                    + n * k * (2 * 4), n * wb * 8 + n * k * c * 2))

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

    out["cost_attention"] = kernel_cost_attention(frames, dev)
    for name, r in out.items():
        say("kernels", f"{name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}), max_abs_err {r['max_abs_err']:.3g}")
    return out


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


def kernel_cost_attention(frames, dev) -> dict:
    from ssf_slam_tpu_torch.ops import attention

    q, k, qc, wn = cost_attention_inputs(frames, dev)
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


def reset_all() -> None:
    from ssf_slam_tpu_torch.ops import attention, banded

    banded.reset_launches()
    attention.reset_launches()


def read_all() -> dict:
    from ssf_slam_tpu_torch.ops import attention, banded

    return {**banded.LAUNCHES, **attention.LAUNCHES}


def bf16_model(dev, fuse: bool):
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.weights import load_tflow

    return load_tflow(FlowNetConfig(npoint=N_POINTS, joint_seg=True,
                                    dtype="bfloat16",
                                    neighbor_backend="banded",
                                    fuse_attention=fuse), device=dev)


def phase_main(frames, dev, fuse: bool) -> tuple[dict, dict]:
    """The whole step over the 32 bench frames; the counters are reset just
    before the run and read just after it."""
    from ssf_slam_tpu_torch.engine.evaluation import ate_rmse
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused

    phase = "main-fused" if fuse else "main"
    model = bf16_model(dev, fuse)
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


def main() -> int:
    args = sys.argv[1:]
    profile_dir = None
    if args:
        if len(args) != 2 or args[0] != "--profile":
            print("usage: python3 chip_smoke.py [--profile DIR]",
                  file=sys.stderr)
            return 2
        profile_dir = args[1]
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from ssf_slam_tpu_torch.ops.precision import set_geom_precision

    set_geom_precision()
    dev = torch.device("cuda")
    try:
        phase_build()
        frames = bench_frames()
        records = phase_kernels(frames, dev)
        phase_f32(frames, dev)
        launches, e2e = phase_main(frames, dev, fuse=False)
        launches_fused, e2e_fused = phase_main(frames, dev, fuse=True)
        if profile_dir is not None:
            # the two settings in turns, each order as often as the other
            # (off, on | on, off | off, on | on, off): the host clock's
            # spread beside their difference
            runs = {False: [e2e["scans_per_s"]],
                    True: [e2e_fused["scans_per_s"]]}
            for fuse in (True, False, False, True, True, False):
                runs[fuse].append(phase_main(frames, dev, fuse)[1][
                    "scans_per_s"])
            med = {fuse: float(np.median(s)) for fuse, s in runs.items()}
            say("turns", "scans/s, fuse_attention off: " + ", ".join(
                f"{s:.2f}" for s in runs[False]) + f" (median "
                f"{med[False]:.2f}); on: " + ", ".join(
                f"{s:.2f}" for s in runs[True]) + f" (median "
                f"{med[True]:.2f})")
            for fuse in (False, True):
                phase_profile(frames, dev, 1e3 / med[fuse], profile_dir,
                              fuse=fuse)
    except (PhaseError, RuntimeError, subprocess.SubprocessError) as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1
    kernels = []
    for name, r in records.items():
        src, replaces = KERNELS[name]
        # each kernel's count from the main path that runs it
        n_launch = (launches_fused if name in PER_SCAN_FUSED
                    else launches)[name]
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
