"""kNN + grouping over a cloud whose points are sharded across the ranks
of a mesh (ssf_slam_tpu/parallel/pointshard.py).

1. Both clouds are Morton-sorted under one ``cloud_box`` and cut into D
   contiguous shards, so shard d's queries find their neighbours mostly in
   target shard d, spilling into d +- 1 near the cuts.
2. Each rank builds an extended local target ``[left neighbour's tail halo
   || local shard || right neighbour's head halo]`` by two rotations of
   ``halo`` rows of points and features (``dist.batch_isend_irecv`` to rank
   +- 1 mod D; at world size 1 both rotations give the rank its own rows).
3. The wrapped halos of the edge ranks are spatially bogus (rank 0's left
   neighbour is rank D-1): the front-wrapped rows become -1e6 and the
   back-wrapped ones +1e6. Direction matters: ``morton_codes`` clamps, and
   the band plan needs the target's codes ascending, so the front rows get
   code 0 and the back rows the largest code; both lose every top-k.
4. The local kNN + grouping runs on the extended target: ``backend=
   "banded"`` is ``ops/neighbors.py::nn_knn_group`` (the ``knn_group``
   kernel on the card), with the distances recomputed in float32 from the
   indices; ``"xla"`` is the exact ``ops/knn.py::knn``.
5. Indices become global rows of the Morton-sorted target; the results are
   all-gathered and put back in the caller's query order.

Neighbours further than one shard boundary plus the halo are missed, as in
the banded engine's three-block window; the tests measure the recall.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ssf_slam_tpu_torch.device import resolve_device
from ssf_slam_tpu_torch.ops.grouping import group_points
from ssf_slam_tpu_torch.ops.knn import knn as exact_knn
from ssf_slam_tpu_torch.ops.neighbors import (
    cloud_box,
    invert_permutation,
    morton_sort,
    nn_knn_group,
)

Tensor = torch.Tensor


def _on(x, device) -> Tensor:
    """A tensor or an array on ``device`` (float64 arrays as float32)."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
        x = torch.from_numpy(x.astype(np.float32) if x.dtype == np.float64
                             else x)
    return x.to(device)


def _rotate(head: Tensor, tail: Tensor, mesh) -> tuple[Tensor, Tensor]:
    """(left neighbour's tail, right neighbour's head) of this rank."""
    d, r = mesh.world_size, mesh.rank
    if d == 1:
        return tail, head
    left, right = (r - 1) % d, (r + 1) % d
    got_tail, got_head = torch.empty_like(tail), torch.empty_like(head)
    # posted in the same order on every rank, so that the two messages
    # between a pair of ranks (D = 2) match in order
    ops = [dist.P2POp(dist.isend, tail.contiguous(), right, mesh.group),
           dist.P2POp(dist.isend, head.contiguous(), left, mesh.group),
           dist.P2POp(dist.irecv, got_tail, left, mesh.group),
           dist.P2POp(dist.irecv, got_head, right, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got_tail, got_head


def _all_gather(t: Tensor, mesh) -> Tensor:
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def pointsharded_knn_group(query, points, feats, k: int, mesh,
                           halo: int = 512, backend: str = "xla",
                           extent: float = 64.0):
    """kNN + feature grouping with the point axis sharded over ``mesh``.
    Every rank passes the whole clouds (query [N, 3], points [M, 3], feats
    [M, C]; N and M divisible by the world size) and gets the whole result:
    (sqdist [N, k] float32, idx [N, k] int32 into the MORTON-SORTED target
    order, grouped [N, k, C]), in the caller's query order, on the mesh's
    device."""
    dev = mesh.device
    n_dev, rank = mesh.world_size, mesh.rank
    q, p, f = (_on(x, dev) for x in (query, points, feats))
    n, m = q.shape[0], p.shape[0]
    if n % n_dev or m % n_dev:
        raise ValueError(f"N {n} and M {m} must divide the world size "
                         f"{n_dev}")
    shard_n, shard_m = n // n_dev, m // n_dev
    if halo > shard_m:
        raise ValueError("halo larger than a target shard")

    box = cloud_box(q[None], p[None])  # origin [1, 3], scale [1]
    q_sorted, q_perm = morton_sort(q[None], box=box)
    t_sorted, t_perm = morton_sort(p[None], box=box)
    f_sorted = f[t_perm[0]]
    q_loc = q_sorted[0, rank * shard_n:(rank + 1) * shard_n]
    t_loc = t_sorted[0, rank * shard_m:(rank + 1) * shard_m]
    f_loc = f_sorted[rank * shard_m:(rank + 1) * shard_m]

    # the halo exchange: points and features ride one float32 payload
    payload = torch.cat([t_loc, f_loc.float()], -1)
    tail, head = _rotate(payload[:halo], payload[-halo:], mesh)
    t_ext = torch.cat([tail[:, :3], t_loc, head[:, :3]])
    f_ext = torch.cat([tail[:, 3:].to(f.dtype), f_loc,
                       head[:, 3:].to(f.dtype)])
    rows = torch.arange(t_ext.shape[0], device=dev)
    front_bogus = (rank == 0) & (rows < halo)
    back_bogus = (rank == n_dev - 1) & (rows >= halo + shard_m)
    big = torch.where(front_bogus[:, None], torch.full_like(t_ext, -1e6),
                      torch.where(back_bogus[:, None],
                                  torch.full_like(t_ext, 1e6), t_ext))
    if backend == "banded":
        idx_loc, grouped, _, _ = nn_knn_group(
            q_loc[None], big[None], f_ext[None], k, backend="banded",
            extent=extent, box=box)
        idx_loc, grouped = idx_loc[0].long(), grouped[0]
        d = torch.sum((q_loc[:, None, :] - big[idx_loc]) ** 2, -1)
    elif backend == "xla":
        d, idx_loc = exact_knn(q_loc, big, k, approx=False)
        grouped = group_points(f_ext, idx_loc)
    else:
        raise ValueError(f"unknown backend {backend}")
    # local -> global sorted-target row
    idx_glob = torch.clamp(idx_loc - halo + rank * shard_m, 0, m - 1)
    d = _all_gather(d.float(), mesh)
    idx = _all_gather(idx_glob.to(torch.int32), mesh)
    grouped = _all_gather(grouped, mesh)
    inv = invert_permutation(q_perm)[0]
    return d[inv], idx[inv], grouped[inv]


def pointshard_reference(query, points, feats, k: int,
                         device: str | torch.device = "cuda"):
    """The one-device oracle in the same index space (the Morton-sorted
    target's rows): (sqdist [N, k], idx [N, k], grouped [N, k, C]), on
    the card unless ``device`` is the CPU."""
    dev = resolve_device(device)
    q, p, f = (_on(x, dev) for x in (query, points, feats))
    box = cloud_box(q[None], p[None])
    t_sorted, t_perm = morton_sort(p[None], box=box)
    d, idx = exact_knn(q, t_sorted[0], k, approx=False)
    return d, idx, group_points(f[t_perm[0]], idx)
