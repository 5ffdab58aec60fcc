"""Within-card sequence batching: aggregate scans/s against the batch B
(the port's counterpart of scripts/batch_economics.py).

The fused SSF step (TFlow flow + seg inference, ego-motion, mapping) runs
over B in {1, 2, 4, 8} sequences at once through
``mesh.run_sequences_fused_batched``: the network once a scan over the
batch, the SLAM step for each member. The configuration is the JAX
script's (batch_economics.py:35-56): SSF with loop closure and scan-to-map
refine off, TFlow at 8192 points with the joint head, bf16, banded; 16
frames of ``generate_sequence(n_points=8192, seed=100 + b, noise=0.004,
n_moving=4)`` for member b, all under one Morton box over the 8
sequences. It loads the committed ``weights/ssf_r3ft2.npz`` (the work is
that of random weights) and so also prints each member's ATE of
``pose_t``.

Each B runs once to warm up, then ``REPEATS`` times in this process;
it prints the median and the range of the aggregate and the per-sequence
scans/s (host clock around a run that ends on the host), the hand-written
kernels' launches a scan and, on the card, the peak memory; then the
markdown table of the JAX script.

    python -m ssf_slam_tpu_torch.parallel.batch_economics [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

N_POINTS = 8192
N_FRAMES = 16
BATCHES = (1, 2, 4, 8)
REPEATS = 3


def economics_configs(dtype: str = "bfloat16"):
    """(PipelineConfig, FlowNetConfig) of batch_economics.py:46-53."""
    from ssf_slam_tpu_torch.config import (
        FlowNetConfig,
        MappingConfig,
        PipelineConfig,
        Variant,
    )

    cfg = PipelineConfig(
        variant=Variant.SSF,
        mapping=MappingConfig(enable_loop_closure=False,
                              scan_to_map_refine=False))
    net = FlowNetConfig(npoint=N_POINTS, joint_seg=True, dtype=dtype,
                        neighbor_backend="banded")
    return cfg, net


def make_sequences(n: int) -> list:
    """The sequences of members 0 .. n-1 (batch_economics.py:61-65)."""
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    return [generate_sequence(n_frames=N_FRAMES, n_points=N_POINTS,
                              seed=100 + b, noise=0.004, n_moving=4)
            for b in range(n)]


def _launches() -> dict:
    """The hand-written kernels' launch counters that are not zero."""
    from ssf_slam_tpu_torch.ops import attention, banded

    return {k: v for k, v in {**banded.LAUNCHES, **attention.LAUNCHES}.items()
            if v}


def _reset_launches() -> None:
    from ssf_slam_tpu_torch.ops import attention, banded

    banded.reset_launches()
    attention.reset_launches()


def measure(model, seqs: list, cfg, batches=BATCHES, repeats: int = REPEATS,
            device="cuda") -> list[dict]:
    """One row a batch B over the first B of ``seqs`` (equal lengths),
    every B under the Morton box of all of ``seqs``: the repeats' aggregate
    scans/s (``agg``), their median, min and max, the kernel launches of
    one run (``launches``, the hand-written kernels' counters by name,
    and their sum a scan), the peak
    memory in MiB on the card (None elsewhere) and each member's ATE of
    pose_t against the generator's poses."""
    from ssf_slam_tpu_torch.device import resolve_device
    from ssf_slam_tpu_torch.engine.evaluation import ate_rmse
    from ssf_slam_tpu_torch.engine.fused import (
        sequence_box,
        stack_fused_scans,
    )
    from ssf_slam_tpu_torch.parallel.mesh import run_sequences_fused_batched

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    n_frames = len(seqs[0])
    n = cfg.lidar.max_points
    box = sequence_box(np.stack([stack_fused_scans(s, n)["points"]
                                 for s in seqs]), device=dev)

    def run(b, frames=None):
        members = [s[:frames] for s in seqs[:b]]
        out = run_sequences_fused_batched(model, members, cfg, device=dev,
                                          box=box)[1]
        if cuda:
            torch.cuda.synchronize()
        return out

    rows = []
    for b in batches:
        run(b, 2)  # warm-up at this batch
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        agg = []
        for _ in range(repeats):
            _reset_launches()
            t0 = time.perf_counter()
            outs = run(b)  # the outputs are on the host
            agg.append(b * n_frames / (time.perf_counter() - t0))
            launches = _launches()
        ate = [ate_rmse(outs["pose_t"][i],
                        np.stack([f["pose1"][1] for f in seqs[i]]))
               for i in range(b)]
        rows.append(dict(
            b=b, agg=agg, median=float(np.median(agg)),
            lo=float(min(agg)), hi=float(max(agg)), launches=launches,
            launches_per_scan=sum(launches.values()) / (b * n_frames),
            peak_mib=(torch.cuda.max_memory_allocated() / 2 ** 20 if cuda
                      else None),
            ate=ate, finite=bool(np.isfinite(outs["pose_t"]).all())))
    return rows


def row_line(r: dict) -> str:
    peak = "" if r["peak_mib"] is None else f", peak {r['peak_mib']:.0f} MiB"
    return (f"B={r['b']}: aggregate {r['median']:.2f} scans/s (range "
            f"{r['lo']:.2f}-{r['hi']:.2f}), per-seq {r['median'] / r['b']:.2f}"
            f" scans/s, {r['launches_per_scan']:.2f} kernel launches a scan"
            f"{peak}, ATE pose_t " + ", ".join(f"{a:.4f}" for a in r["ate"])
            + " m")


def table(rows: list[dict]) -> str:
    """The JAX script's markdown table, with the medians; scaling against
    the first row's B (1)."""
    base = rows[0]["median"]
    lines = ["| B | aggregate scans/s | per-seq scans/s | scaling vs B=1 |",
             "|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['b']} | {r['median']:.1f} | "
                     f"{r['median'] / r['b']:.1f} | "
                     f"{r['median'] / base:.2f}x |")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ssf_slam_tpu_torch.device import resolve_device
    from ssf_slam_tpu_torch.ops.precision import set_geom_precision
    from ssf_slam_tpu_torch.weights import load_tflow

    dev = resolve_device(args.device)
    set_geom_precision()
    cfg, net = economics_configs()
    model = load_tflow(net, device=dev)
    rows = measure(model, make_sequences(max(BATCHES)), cfg, BATCHES,
                   REPEATS, dev)
    for r in rows:
        print(row_line(r), flush=True)
    print()
    print(table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
