"""Neighbour-engine dispatch: banded CUDA kernels vs exact selection
(ssf_slam_tpu/ops/neighbors.py).

``band_params(n, m, k)`` picks, per call site, the banded tiling or None;
None takes the exact-selection path (ops/knn.py + ops/grouping.py +
segment sums), as the JAX package's XLA fallback does. All functions are
batched ([B, N, ...]) and differentiable, with the JAX module's gradient
surface:

- the exact path differentiates through everything PyTorch's autograd
  sees, as JAX does through its XLA path: the re-ranked kNN distances
  carry gradient into both clouds (so ``nn_knn_idw``'s IDW weights do);
- on the banded path the ``torch.autograd.Function``s mirror the JAX custom
  VJPs: kNN indices and distances carry no gradient; grouping and regroup
  send gradient to the features only; IDW interpolation to the fields
  only, with the weights held constant; the scatter softmax-sum is
  differentiable in both values and logits, the global-max shift detached.

Each grouping backward's segment sum (neighbors.py:181-185, :252-257,
:321-325, :374-378) is ``banded.scatter_add``: the same function, since
every idx there comes from a top-k inside its tile's band. It accumulates
in float32 and is cast to the features' type, where JAX sums the
cotangent in its own type: equal in float32, within bf16 rounding in bf16.
``SEGMENT_SUMS`` counts the segment sums the backward passes asked for,
the number of ``scatter_add`` launches on the card.
"""

from __future__ import annotations

import torch

from ssf_slam_tpu_torch.ops import banded
from ssf_slam_tpu_torch.ops.grouping import group_points
from ssf_slam_tpu_torch.ops.interp import idw_weights
from ssf_slam_tpu_torch.ops.knn import knn as exact_knn
from ssf_slam_tpu_torch.ops.morton import morton_codes

Tensor = torch.Tensor

# banded pays off only when the [N, M] distance matrix would be large
_MIN_WORK = 1 << 20

SEGMENT_SUMS = {"backward": 0}


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


def _segment_sum(idx: Tensor, vals: Tensor, plan, params, n_out: int,
                 dtype) -> Tensor:
    """sum of vals [B, N, k, C] per row idx [B, N, k] -> [B, n_out, C] in
    ``dtype``: the banded scatter-add kernel on the card."""
    SEGMENT_SUMS["backward"] += 1
    return banded.scatter_add(idx, vals.contiguous(), plan, params,
                              n_out).to(dtype)


class _KnnGroup(torch.autograd.Function):
    """Banded kNN + grouping; the gradient goes to feats only
    (neighbors.py::_bknn_group)."""

    @staticmethod
    def forward(ctx, query, points, feats, b0, n_valid, k, params):
        _, idx, grouped = banded.knn_group(
            query.contiguous(), points.contiguous(), feats.contiguous(), k,
            (b0, n_valid), params)
        ctx.save_for_backward(idx, b0)
        ctx.meta = (params, feats.shape[-2], feats.dtype)
        ctx.mark_non_differentiable(idx)
        return idx, grouped

    @staticmethod
    def backward(ctx, _, g):
        idx, b0 = ctx.saved_tensors
        params, m, dtype = ctx.meta
        gf = _segment_sum(idx, g, (b0, None), params, m, dtype)
        return None, None, gf, None, None, None, None


def nn_knn(query: Tensor, points: Tensor, k: int, backend: str = "xla",
           extent: float = 64.0, box=None) -> tuple[Tensor, Tensor]:
    """kNN dispatch: (sqdist, idx) [B, N, k]. The banded distances carry no
    gradient; the exact path's do, as in the JAX package."""
    n, m = query.shape[-2], points.shape[-2]
    params = band_params(n, m, k) if backend == "banded" else None
    if params is None:
        return exact_knn(query, points, k, approx=True)
    plan = make_plan(query, points, params, extent, box)
    d, idx = banded.knn(query.detach().contiguous(),
                        points.detach().contiguous(), k, plan, params)
    return d, idx


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
    idx, grouped = _KnnGroup.apply(query.detach(), points.detach(), feats,
                                   plan[0], plan[1], k, params)
    return idx, grouped, plan, params


class _KnnGroup2(torch.autograd.Function):
    """Twin banded kNN + grouping under one plan; the gradient goes to the
    shared feats only (neighbors.py::_bknn_group2)."""

    @staticmethod
    def forward(ctx, qa, qb, pa, pb, feats, b0, n_valid, k, params):
        _, ia, ga, _, ib, gb = banded.knn_group2(
            qa.contiguous(), qb.contiguous(), pa.contiguous(),
            pb.contiguous(), feats.contiguous(), k, (b0, n_valid), params)
        ctx.save_for_backward(ia, ib, b0)
        ctx.meta = (params, feats.shape[-2], feats.dtype)
        ctx.mark_non_differentiable(ia, ib)
        return ia, ga, ib, gb

    @staticmethod
    def backward(ctx, _a, g_a, _b, g_b):
        ia, ib, b0 = ctx.saved_tensors
        params, m, dtype = ctx.meta
        # the two segment sums add in float32, then one cast, as JAX adds
        # its two sums before the cast
        gf = (_segment_sum(ia, g_a, (b0, None), params, m, torch.float32)
              + _segment_sum(ib, g_b, (b0, None), params, m, torch.float32))
        return None, None, None, None, gf.to(dtype), None, None, None, None


def nn_knn_group2(query_a: Tensor, query_b: Tensor, points_a: Tensor,
                  points_b: Tensor, feats: Tensor, k: int,
                  backend: str = "xla", extent: float = 64.0, box=None):
    """The cost volume's twin kNN + grouping calls in one band stream.

    Falls back to two ``nn_knn_group`` calls off the banded path. Returns
    (idx_a, grouped_a, idx_b, grouped_b, plan, params): the shared plan,
    made from (query_a, points_a), serves nn_regroup on idx_a and
    nn_scatter_softmax_sum on idx_b.
    """
    n, m = query_a.shape[-2], points_a.shape[-2]
    params = band_params(n, m, k) if backend == "banded" else None
    if params is None:
        ia, ga, _, _ = nn_knn_group(query_a, points_a, feats, k,
                                    backend=backend, extent=extent, box=box)
        ib, gb, _, _ = nn_knn_group(query_b, points_b, feats, k,
                                    backend=backend, extent=extent, box=box)
        return ia, ga, ib, gb, None, None
    plan = make_plan(query_a, points_a, params, extent, box)
    ia, ga, ib, gb = _KnnGroup2.apply(
        query_a.detach(), query_b.detach(), points_a.detach(),
        points_b.detach(), feats, plan[0], plan[1], k, params)
    return ia, ga, ib, gb, plan, params


class _KnnIdw(torch.autograd.Function):
    """Banded kNN + IDW interpolation; the gradient goes to the fields, the
    IDW weights of the kernel's distances held constant
    (neighbors.py::_bknn_idw)."""

    @staticmethod
    def forward(ctx, query, points, fields, b0, n_valid, k, params):
        out, d, idx = banded.knn_idw(query.contiguous(), points.contiguous(),
                                     fields.contiguous(), k, (b0, n_valid),
                                     params)
        ctx.save_for_backward(d, idx, b0)
        ctx.meta = (params, fields.shape[-2], fields.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        d, idx, b0 = ctx.saved_tensors
        params, m, dtype = ctx.meta
        vals = idw_weights(d)[..., None] * g.float()[..., None, :]
        gf = _segment_sum(idx, vals, (b0, None), params, m, dtype)
        return None, None, gf, None, None, None, None


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
    return _KnnIdw.apply(query.detach(), points.detach(), fields, plan[0],
                         plan[1], k, params)


class _Regroup(torch.autograd.Function):
    """Grouping by banded indices; the gradient goes to feats
    (neighbors.py::_bregroup)."""

    @staticmethod
    def forward(ctx, idx, feats, b0, params):
        ctx.save_for_backward(idx, b0)
        ctx.meta = (params, feats.shape[-2], feats.dtype)
        return banded.regroup(idx, feats.contiguous(), (b0, None), params)

    @staticmethod
    def backward(ctx, g):
        idx, b0 = ctx.saved_tensors
        params, m, dtype = ctx.meta
        return None, _segment_sum(idx, g, (b0, None), params, m,
                                  dtype), None, None


def nn_regroup(feats: Tensor, idx: Tensor, plan, params) -> Tensor:
    """Group feats [B, M, C] by idx [B, N, K] produced under ``plan``."""
    if params is None:
        return group_points(feats, idx)
    return _Regroup.apply(idx, feats, plan[0], params)


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


class _ScatterSoftmaxSum(torch.autograd.Function):
    """Banded scatter softmax-sum; differentiable in vals and logits
    (neighbors.py::_bscatter_softmax_sum)."""

    @staticmethod
    def forward(ctx, vals, w, idx, b0, n_out, params):
        # global-max stabilisation outside the kernel (shift-invariant per
        # segment), in the logits' type, as neighbors.py:414 does
        shift = torch.max(w)
        s = banded.scatter_softmax_sum(
            idx, vals.contiguous(), (w - shift).float().contiguous(),
            (b0, None), params, n_out)
        denom = torch.clamp(s[..., -1:], min=1e-16)
        out = s[..., :-1] / denom
        if any(ctx.needs_input_grad[:2]):
            soft = torch.exp(w - shift) / group_points(denom, idx)[..., 0]
            ctx.save_for_backward(soft, idx, vals, out)
        return out

    @staticmethod
    def backward(ctx, g):
        soft, idx, vals, out = ctx.saved_tensors
        g = g.float()
        gm = group_points(g, idx)  # cotangent rows at each idx
        om = group_points(out, idx)
        dvals = (soft[..., None] * gm).to(vals.dtype)
        # dL/dw = soft * <vals - out[m], g[m]> (softmax within a segment)
        dw = soft * torch.sum((vals.float() - om) * gm, dim=-1)
        return dvals, dw, None, None, None, None


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
    return _ScatterSoftmaxSum.apply(vals, w, idx.to(torch.int32), plan[0],
                                    n_out, params)
