"""The band kNN kernels of two checkouts of the port, timed on one card.

Run from the root of a checkout on a machine with one NVIDIA H100, with a
second checkout (for example the parent commit, unpacked with
``git archive``) as OLD:

    python3 chip_ab_knn.py OLD [NEW]

It imports nothing of JAX and nothing of the JAX package. Four processes
run in turn, OLD, NEW, NEW, OLD (NEW defaults to this checkout); each
imports the port (``ssf_slam_tpu_torch``) of its checkout, builds that
checkout's kernels there, and runs knn_group, knn_idw, knn and knn_group2
on chip_smoke.py phase 2's level-0 inputs: bench frames 0 and 1,
Morton-sorted under the sequence box, feats from seed 0 (knn_group:
8192 <- 8192, k = 16, C = 99 f32; knn_idw: 8192 <- 2048, k = 7, C = 132
bf16), at batch 1 and, for knn_group and knn_idw, also batch 4 (frame pairs
(0, 1), (2, 3), (4, 5), (6, 7)). Each time is taken two ways, in both
checkouts alike:

- ``loop``: chip_smoke.py's cuda_ms, CUDA events around 20 launches queued
  after a synchronize, so that the wrappers' host work counts wherever it
  outlasts the kernels;
- ``queued``: chip_smoke.py's queued_ms, the same 20 launches queued behind
  a device-side sleep, so that the events time the kernels alone.

Both come from this checkout's chip_smoke.py, imported before the port.

Each process also hashes every output; the checkouts must agree on them
bit for bit. Prints the card's name and power limit, one line per kernel,
batch and method (OLD's two readings, NEW's two, NEW / OLD of their means)
and, last, one JSON object of every reading. Exits nonzero when CUDA is
absent or the outputs differ.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

from chip_smoke import cuda_ms, queued_ms

N_POINTS = 8192


def digest(tensors) -> str:
    """A hash of the tensors' bytes."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def child(root: str, dev: str = "cuda") -> dict:
    """Readings of the port under ``root``: {tag: {loop, queued, digest}}."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import ssf_slam_tpu_torch
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.engine.fused import sequence_box, stack_fused_scans
    from ssf_slam_tpu_torch.ops import banded, cuda_build
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

    def take(tag, fn):
        got = fn()
        out[tag] = dict(loop=cuda_ms(fn), queued=queued_ms(fn),
                        digest=digest(got))

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
        take(f"knn_group B={bsz} 8192<-8192 k=16 C=99 f32",
             lambda: banded.knn_group(q, p, feats, 16, plan, params))
        if bsz == 1:
            take("knn B=1 8192<-8192 k=16",
                 lambda: banded.knn(q, p, 16, plan, params))
            qb = (q + 0.05 * torch.randn(q.shape, generator=gen,
                                         device=dev)).contiguous()
            pb = (p + 0.05 * torch.randn(p.shape, generator=gen,
                                         device=dev)).contiguous()
            take("knn_group2 B=1 2x 8192<-8192 k=16 C=99 f32",
                 lambda: banded.knn_group2(q, qb, p, pb, feats, 16, plan,
                                           params))
        iparams = nb.band_params(N_POINTS, sparse.shape[1], 7)
        iplan = nb.make_plan(q, sparse, iparams, 64.0, box)
        take(f"knn_idw B={bsz} 8192<-2048 k=7 C=132 bf16",
             lambda: banded.knn_idw(q, sparse, fields, 7, iplan, iparams))
    return out


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--child":
        print(json.dumps(child(args[1])), flush=True)
        return 0
    if len(args) not in (1, 2):
        print("usage: python3 chip_ab_knn.py OLD [NEW]", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_knn: CUDA is not available", file=sys.stderr)
        return 2
    old = args[0]
    new = args[1] if len(args) == 2 else os.path.dirname(
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
            [sys.executable, os.path.abspath(__file__), "--child", root],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        runs.append((side, json.loads(proc.stdout.strip().splitlines()[-1])))
    same = True
    for tag in runs[0][1]:
        digests = {r[tag]["digest"] for _, r in runs}
        same &= len(digests) == 1
        for method in ("loop", "queued"):
            got = {s: [r[tag][method] for side, r in runs if side == s]
                   for s in ("old", "new")}
            ratio = (sum(got["new"]) / len(got["new"])) / (
                sum(got["old"]) / len(got["old"]))
            print(f"[ab] {tag} {method}: old "
                  + " ".join(f"{t:.4f}" for t in got["old"]) + " ms, new "
                  + " ".join(f"{t:.4f}" for t in got["new"])
                  + f" ms, new/old {ratio:.3f}; outputs "
                  + ("equal" if len(digests) == 1 else
                     "DIFFER " + " ".join(sorted(digests))), flush=True)
    print(json.dumps({"card": smi, "order": [s for s, _ in runs],
                      "readings": [r for _, r in runs]}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
