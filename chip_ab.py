"""Kernels of two checkouts of the port, timed on one card.

Run from the root of a checkout on a machine with one NVIDIA H100, with a
second checkout (for example the parent commit, unpacked with
``git archive``) as OLD:

    python3 chip_ab.py KERNELS OLD [NEW]

KERNELS is a comma-separated list of knn_group, knn_idw, knn, knn_group2,
cost_attention, scatter_add, regroup, scatter_softmax_sum and attention, or
``all``.
It imports nothing of JAX and nothing of the JAX package. Four processes
run in turn, OLD, NEW, NEW, OLD (NEW defaults to this checkout); each
imports the port (``ssf_slam_tpu_torch``) of its checkout, builds that
checkout's kernels there, and runs the kernels asked for on
chip_smoke.py's inputs: bench frames Morton-sorted under the sequence
box, at batch 1 and 4 (frame pairs (0, 1), (2, 3), (4, 5), (6, 7)):

- knn_group: 8192 <- 8192, k = 16, C = 99 f32; knn_idw: 8192 <- 2048,
  k = 7, C = 132 bf16; knn and knn_group2 at knn_group's shape, at batch
  1 and 4 (knn_group2 also with bf16 feats);
- cost_attention: the inputs of its two launches a scan (phase 2's
  cost_attention_levels: flow0_r at 8192 points, flow1_r at 2048, with the
  folded weightnet of the committed weights), bf16;
- scatter_add: the level-0 cost volume's segment sum, knn_group's indices
  and a seeded cotangent [B, 8192, 16, 99], float32 and bf16; then the 18
  segment sums of one bf16 train step (8192 points, batch 4: bench pairs
  0-3, the committed weights, train mode), each shape with its inputs as
  the step made them, and their sum a step (calls x time);
- regroup: the level-0 cost volume's patch grouping, knn_group's indices
  and seeded costs [B, 8192, 64] bf16;
- scatter_softmax_sum: the level-0 cost volume's backward cost,
  knn_group's indices, seeded values [B, 8192, 16, 64] bf16 and logits
  shifted by their maximum;
- attention: the level-0 cost volume's q_feat and k_feat (phase 2's
  inputs; at batch 4 those of frame pairs (0, 1) ... (6, 7)), [B, 8192,
  16, 64], in bf16 and in float32.

Each time is taken two ways, in both checkouts alike:

- ``loop``: chip_smoke.py's cuda_ms, CUDA events around 20 launches queued
  after a synchronize, so that the wrappers' host work counts wherever it
  outlasts the kernels;
- ``queued``: chip_smoke.py's queued_ms, the same 20 launches queued behind
  a device-side sleep, so that the events time the kernels alone.

Both come from this checkout's chip_smoke.py, imported before the port.

knn_group, knn_idw, knn, knn_group2 and regroup must give the same bits
in every process (a hash of their outputs). cost_attention, attention and
the scatters sum in another order than the old kernels, so each process
holds them to a reference instead: cost_attention to its own checkout's
plain version within chip_smoke.py's COST_ATTENTION_TOL, attention to its
own checkout's plain version within chip_smoke.py's attention_agreement
(bf16 within ATTENTION_TOL, float32 within 1e-5), scatter_add and
scatter_softmax_sum to their own checkout's plain versions within
chip_smoke.py's scatter_agreement and softmax_agreement (1e-5 + 1e-5 |want|
beyond the rounding bound of two float32 sums).
Prints the card's name and power limit, one line per kernel, shape and
method (OLD's two readings, NEW's two, NEW / OLD of their means) and,
last, one JSON object of every reading. Exits nonzero when CUDA is absent,
an output hash differs or NEW misses a tolerance (OLD's misses are
reported).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

from chip_smoke import (TRAIN_BATCH, attention_agreement,
                        cost_attention_agreement, cost_attention_levels,
                        cuda_ms, queued_ms, scatter_agreement,
                        softmax_agreement, spy_scatter)

N_POINTS = 8192
KERNELS = ("knn_group", "knn_idw", "knn", "knn_group2", "cost_attention",
           "scatter_add", "regroup", "scatter_softmax_sum", "attention")
TRAIN_TAG = "scatter_add train step"


def digest(tensors) -> str:
    """A hash of the tensors' bytes."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def train_step_sums(frames, dev) -> dict:
    """{(vals shape, type, wblk, n_out): [inputs, calls]} of the segment
    sums of one bf16 train step's backward (8192 points, batch 4, train
    mode, the committed weights), from chip_smoke.py's spy_scatter."""
    import numpy as np
    import torch

    from ssf_slam_tpu_torch.config import FlowNetConfig, LossConfig
    from ssf_slam_tpu_torch.train.trainer import forward_loss, to_device
    from ssf_slam_tpu_torch.weights import load_tflow

    batch = to_device({k: np.stack([f[k] for f in frames[:TRAIN_BATCH]])
                       for k in ("pos1", "pos2", "gt", "mask1", "s_fg_mask")},
                      dev)
    model = load_tflow(FlowNetConfig(npoint=N_POINTS, joint_seg=True,
                                     dtype="bfloat16",
                                     neighbor_backend="banded"), device=dev)
    model.train()
    params = list(model.parameters())
    loss, _ = forward_loss(model, batch, LossConfig())
    shapes = {}
    with spy_scatter(shapes):
        torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    return shapes


def child(root: str, kernels: list[str], dev: str = "cuda") -> dict:
    """Readings of the port under ``root``: {tag: {loop, queued, digest or
    agree}}."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import ssf_slam_tpu_torch
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.engine.fused import sequence_box, stack_fused_scans
    from ssf_slam_tpu_torch.ops import attention, banded, cuda_build
    from ssf_slam_tpu_torch.ops import neighbors as nb
    from ssf_slam_tpu_torch.ops.precision import set_geom_precision

    pkg = os.path.abspath(ssf_slam_tpu_torch.__file__)
    if not pkg.startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {pkg}, not the port under {root}")
    set_geom_precision()
    cuda_build.build_all()
    dev = torch.device(dev)
    frames = generate_sequence(n_frames=32, n_points=N_POINTS, seed=0,
                               noise=0.004, n_moving=4)[:8]
    scans = stack_fused_scans(frames, N_POINTS)
    box = sequence_box(scans["points"], device=dev)
    clouds = [nb.morton_sort(torch.as_tensor(scans["points"][i:i + 1],
                                             device=dev), box=box)[0]
              for i in range(8)]
    out = {}

    def take(tag, fn, agree=None, calls=1):
        got = fn()
        reading = dict(loop=cuda_ms(fn), queued=queued_ms(fn), calls=calls)
        if agree is None:
            reading["digest"] = digest(got)
        else:
            reading["agree"], reading["agreement"] = agree(got)
        out[tag] = reading

    for bsz in (1, 4):
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.cat(clouds[0:2 * bsz:2])
        p = torch.cat(clouds[1:2 * bsz:2])
        sparse = p[:, ::4].contiguous()
        feats = torch.randn(bsz, N_POINTS, 99, generator=gen, device=dev)
        fields = torch.randn(bsz, sparse.shape[1], 132, generator=gen,
                             device=dev).to(torch.bfloat16)
        params = nb.band_params(N_POINTS, N_POINTS, 16)
        plan = nb.make_plan(q, p, params, 64.0, box)
        if "knn_group" in kernels:
            take(f"knn_group B={bsz} 8192<-8192 k=16 C=99 f32",
                 lambda: banded.knn_group(q, p, feats, 16, plan, params))
        if "knn" in kernels:
            take(f"knn B={bsz} 8192<-8192 k=16",
                 lambda: banded.knn(q, p, 16, plan, params))
        if "knn_group2" in kernels:
            qb = (q + 0.05 * torch.randn(q.shape, generator=gen,
                                         device=dev)).contiguous()
            pb = (p + 0.05 * torch.randn(p.shape, generator=gen,
                                         device=dev)).contiguous()
            for f in (feats, feats.to(torch.bfloat16)):
                dt = str(f.dtype).split(".")[-1]
                take(f"knn_group2 B={bsz} 2x 8192<-8192 k=16 C=99 {dt}",
                     lambda f=f: banded.knn_group2(q, qb, p, pb, f, 16, plan,
                                                   params))
        if "knn_idw" in kernels:
            iparams = nb.band_params(N_POINTS, sparse.shape[1], 7)
            iplan = nb.make_plan(q, sparse, iparams, 64.0, box)
            take(f"knn_idw B={bsz} 8192<-2048 k=7 C=132 bf16",
                 lambda: banded.knn_idw(q, sparse, fields, 7, iplan,
                                        iparams))
        if "scatter_add" in kernels:
            _, idx, _ = banded.knn_group_plain(q, p, feats, 16, plan, params)
            cot = torch.randn(bsz, N_POINTS, 16, 99, generator=gen,
                              device=dev)
            for vals in (cot, cot.to(torch.bfloat16)):

                def close(got, vals=vals):
                    ok, err = scatter_agreement(got, idx, vals, plan, params,
                                                N_POINTS)
                    return ok, f"max error {err:.3g}"

                dt = str(vals.dtype).split(".")[-1]
                take(f"scatter_add B={bsz} 8192x16x99 {dt}",
                     lambda vals=vals: banded.scatter_add(
                         idx, vals, plan, params, N_POINTS), close)
        # regroup and scatter_softmax_sum draw from a generator of their
        # own, so that the inputs above stay those of earlier checkouts
        gen2 = torch.Generator(device=dev).manual_seed(1)
        if "regroup" in kernels or "scatter_softmax_sum" in kernels:
            _, idx, _ = banded.knn_group_plain(q, p, feats, 16, plan, params)
        if "regroup" in kernels:
            cost = torch.randn(bsz, N_POINTS, 64, generator=gen2,
                               device=dev).to(torch.bfloat16)
            take(f"regroup B={bsz} [8192,16]x[8192,64] bf16",
                 lambda: banded.regroup(idx, cost, plan, params))
        if "scatter_softmax_sum" in kernels:
            vals = torch.randn(bsz, N_POINTS, 16, 64, generator=gen2,
                               device=dev).to(torch.bfloat16)
            w = torch.randn(bsz, N_POINTS, 16, generator=gen2, device=dev)
            w = (w - w.max()).contiguous()

            def within(got):
                ok, err = softmax_agreement(got, idx, vals, w, plan, params,
                                            N_POINTS)
                return ok, f"max error {err:.3g}"

            take(f"scatter_softmax_sum B={bsz} 8192x16x64 bf16",
                 lambda: banded.scatter_softmax_sum(idx, vals, w, plan,
                                                    params, N_POINTS),
                 within)
    if "scatter_add" in kernels:
        for key, (args, calls) in sorted(train_step_sums(frames,
                                                         dev).items()):

            def close(got, args=args):
                ok, err = scatter_agreement(got, *args)
                return ok, f"max error {err:.3g}"

            shape = "x".join(map(str, key[0]))
            take(f"{TRAIN_TAG} x{calls} {shape} {key[1]} -> {key[3]} "
                 f"(wblk {key[2]})",
                 lambda args=args: banded.scatter_add(*args), close, calls)
    if "cost_attention" in kernels:
        for n, (qf, kf, qc, wn) in sorted(
                cost_attention_levels(frames, dev).items(), reverse=True):
            want = attention.cost_attention_plain(qf, kf, qc, wn)

            def within(got, want=want):
                ok, _, line = cost_attention_agreement(got, want)
                return ok, line

            take(f"cost_attention [{n},16,64] C2=32 bf16",
                 lambda qf=qf, kf=kf, qc=qc, wn=wn:
                 attention.cost_attention_fused(qf, kf, qc, wn), within)
    if "attention" in kernels:
        for bsz in (1, 4):
            qf, kf = cost_attention_levels(frames, dev,
                                           pairs=bsz)[N_POINTS][:2]
            for dt in (torch.bfloat16, torch.float32):
                a, b = qf.to(dt), kf.to(dt)
                want = attention.attention_plain(a, b)

                def close(got, want=want):
                    ok, _, line = attention_agreement(got, want)
                    return ok, line

                take(f"attention B={bsz} [8192,16,64] "
                     f"{str(dt).split('.')[-1]}",
                     lambda a=a, b=b: attention.attention_fused(a, b), close)
    return out


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--child":
        print(json.dumps(child(args[2], args[1].split(","))), flush=True)
        return 0
    if len(args) not in (2, 3):
        print("usage: python3 chip_ab.py KERNELS OLD [NEW]", file=sys.stderr)
        return 2
    kernels = list(KERNELS) if args[0] == "all" else args[0].split(",")
    if not set(kernels) <= set(KERNELS):
        print(f"chip_ab: kernels are {', '.join(KERNELS)} or all",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available", file=sys.stderr)
        return 2
    old = args[1]
    new = args[2] if len(args) == 3 else os.path.dirname(
        os.path.abspath(__file__))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for side, root in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             ",".join(kernels), root],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        runs.append((side, json.loads(proc.stdout.strip().splitlines()[-1])))
    good = True
    for tag in runs[0][1]:
        readings = [r[tag] for _, r in runs]
        if "digest" in readings[0]:
            digests = {r["digest"] for r in readings}
            verdict = ("outputs equal" if len(digests) == 1 else
                       "outputs DIFFER " + " ".join(sorted(digests)))
            good &= len(digests) == 1
        else:
            agree = [r["agree"] for r in readings]
            verdict = ("each within its tolerance" if all(agree) else
                       "MISSES its tolerance in " + ", ".join(
                           s for (s, _), a in zip(runs, agree) if not a))
            good &= all(a for (s, _), a in zip(runs, agree) if s == "new")
        for method in ("loop", "queued"):
            got = {s: [r[tag][method] for side, r in runs if side == s]
                   for s in ("old", "new")}
            ratio = (sum(got["new"]) / len(got["new"])) / (
                sum(got["old"]) / len(got["old"]))
            print(f"[ab] {tag} {method}: old "
                  + " ".join(f"{t:.4f}" for t in got["old"]) + " ms, new "
                  + " ".join(f"{t:.4f}" for t in got["new"])
                  + f" ms, new/old {ratio:.3f}; {verdict}", flush=True)
        for (side, r) in runs:
            if "agreement" in r[tag]:
                print(f"[ab] {tag} {side}: {r[tag]['agreement']}",
                      flush=True)
    train = [tag for tag in runs[0][1] if tag.startswith(TRAIN_TAG)]
    for method in ("loop", "queued") if train else ():
        got = {s: [sum(r[t][method] * r[t]["calls"] for t in train)
                   for side, r in runs if side == s] for s in ("old", "new")}
        ratio = sum(got["new"]) / sum(got["old"])
        print(f"[ab] {TRAIN_TAG}, its "
              f"{sum(runs[0][1][t]['calls'] for t in train)} segment sums "
              f"(calls x time) {method}: old "
              + " ".join(f"{t:.4f}" for t in got["old"]) + " ms, new "
              + " ".join(f"{t:.4f}" for t in got["new"])
              + f" ms, new/old {ratio:.3f}", flush=True)
    print(json.dumps({"card": smi, "order": [s for s, _ in runs],
                      "readings": [r for _, r in runs]}), flush=True)
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
