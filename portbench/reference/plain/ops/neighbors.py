"""Neighbour-engine dispatch: banded CUDA kernels vs exact selection
(ssf_slam_tpu/ops/neighbors.py).

``band_params(n, m, k)`` picks, per call site, the banded tiling or None;
None takes the exact-selection path (ops/knn.py + ops/grouping.py +
segment sums), as the JAX package's XLA fallback does. All functions are
batched ([B, N, ...]); the reference computes forward only.
"""

from __future__ import annotations

import torch

from portbench.reference.plain.ops import banded
from portbench.reference.plain.ops.grouping import group_points
from portbench.reference.plain.ops.interp import idw_weights
from portbench.reference.plain.ops.knn import knn as exact_knn
from portbench.reference.plain.ops.morton import morton_codes

Tensor = torch.Tensor

# banded pays off only when the [N, M] distance matrix would be large
_MIN_WORK = 1 << 20

def band_params(n: int, m: int, k: int) -> tuple[int, int, int] | None:
    """(query_tile, wblk, n_blocks) or None (take the exact path)."""
    if k > 32 or n * m < _MIN_WORK or n % 256:
        return None
    if m % 256 == 0 and m // 256 >= 3:
        return (256, 256, 3)
    if m % 128 == 0 and m // 128 >= 3:
        return (256, 128, 3)
    return None


def cloud_box(*clouds: Tensor) -> tuple[Tensor, Tensor]:
    """Per-batch isotropic Morton box covering all clouds:
    (origin [B, 3], scale [B])."""
    both = torch.cat(clouds, dim=-2)
    origin = torch.amin(both, dim=-2)
    scale = torch.amax(torch.amax(both, dim=-2) - origin, dim=-1) + 1e-3
    return origin, scale


def morton_sort(points: Tensor, extent: float = 64.0,
                box=None) -> tuple[Tensor, Tensor]:
    """Sort [B, N, 3] points by Morton code. Returns (sorted, perm); the
    sort is stable, as ``jnp.argsort`` is."""
    origin = scale = None
    if box is not None:
        origin, scale = box[0][..., None, :], box[1][..., None, None]
    codes = morton_codes(points, extent, origin, scale)
    perm = torch.sort(codes, dim=-1, stable=True).indices
    return torch.gather(points, -2, perm[..., None].expand(-1, -1, 3)), perm


def invert_permutation(perm: Tensor) -> Tensor:
    return torch.sort(perm, dim=-1, stable=True).indices


def make_plan(query: Tensor, points: Tensor, params, extent: float,
              box=None):
    """The band plan of a (query, points) pair, reusable by every banded op
    on that pair."""
    qt, wblk, nb = params
    return banded.plan_bands(query, points, qt, wblk, nb, extent, box)


def nn_knn_group(query: Tensor, points: Tensor, feats: Tensor, k: int,
                 backend: str = "xla", extent: float = 64.0, box=None):
    """Fused kNN + grouping.

    Returns (idx [B, N, k], grouped [B, N, k, C], plan, params); plan and
    params are not None only on the banded path, for nn_regroup /
    nn_scatter_softmax_sum on the same pair.
    """
    n, m = query.shape[-2], points.shape[-2]
    params = band_params(n, m, k) if backend == "banded" else None
    if params is None:
        _, idx = exact_knn(query, points, k, approx=True)
        return idx, group_points(feats, idx), None, None
    plan = make_plan(query, points, params, extent, box)
    _, idx, grouped = banded.knn_group(
        query.contiguous(), points.contiguous(), feats.contiguous(), k,
        plan, params)
    return idx, grouped, plan, params


def nn_knn_idw(query: Tensor, points: Tensor, fields: Tensor, k: int,
               backend: str = "xla", extent: float = 64.0,
               box=None) -> Tensor:
    """out[b, i] = sum_j idw_w_j * fields[b, idx_j] (UpsampleFlow /
    PointWarping inner loop). The exact path returns the promoted type of
    the weights and fields (float32), the banded path the fields' type, as
    in the JAX package."""
    n, m = query.shape[-2], points.shape[-2]
    params = band_params(n, m, k) if backend == "banded" else None
    if params is None:
        d, idx = exact_knn(query, points, k, approx=True)
        w = idw_weights(d)
        return torch.sum(w[..., None] * group_points(fields, idx), dim=-2)
    plan = make_plan(query, points, params, extent, box)
    return banded.knn_idw(query.contiguous(), points.contiguous(),
                          fields.contiguous(), k, plan, params)[0]


def nn_regroup(feats: Tensor, idx: Tensor, plan, params) -> Tensor:
    """Group feats [B, M, C] by idx [B, N, K] produced under ``plan``."""
    if params is None:
        return group_points(feats, idx)
    return banded.regroup(idx, feats.contiguous(), (plan[0], None), params)


def _segment_softmax_sum(values: Tensor, weights: Tensor, ids: Tensor,
                         num_segments: int) -> Tensor:
    """models/costvolume.py::_segment_softmax_sum for one batch element:
    values [R, C], weights [R], ids [R] -> [num_segments, C], in the
    values' type; a global max, detached, stabilises every segment's
    softmax."""
    ex = torch.exp(weights - torch.max(weights).detach())
    denom = torch.zeros(num_segments, dtype=ex.dtype, device=ex.device)
    denom = denom.index_add(0, ids, ex)
    soft = ex / torch.clamp(denom[ids], min=1e-16)
    out = torch.zeros(num_segments, values.shape[-1],
                      dtype=torch.promote_types(values.dtype, soft.dtype),
                      device=values.device)
    return out.index_add(0, ids, values * soft[:, None])


def nn_scatter_softmax_sum(vals: Tensor, w: Tensor, idx: Tensor, n_out: int,
                           plan=None, params=None) -> Tensor:
    """Per-segment softmax(w) applied to vals [B, N, K, C], summed per
    output row idx [B, N, K] -> [B, n_out, C]."""
    if params is None:
        bsz, c = idx.shape[0], vals.shape[-1]
        return torch.stack([
            _segment_softmax_sum(vals[b].reshape(-1, c), w[b].reshape(-1),
                                 idx[b].reshape(-1).long(), n_out)
            for b in range(bsz)])
    # global-max stabilisation outside the kernel (shift-invariant per
    # segment), in the logits' type, as neighbors.py:414 does
    s = banded.scatter_softmax_sum(
        idx.to(torch.int32), vals.contiguous(),
        (w - torch.max(w)).float().contiguous(), (plan[0], None), params,
        n_out)
    return s[..., :-1] / torch.clamp(s[..., -1:], min=1e-16)
