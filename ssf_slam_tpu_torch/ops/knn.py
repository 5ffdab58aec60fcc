"""k-nearest neighbours by exact selection (ssf_slam_tpu/ops/knn.py).

This is the path the small pyramid levels take (``band_params`` returns
None) and the mapping back end's association. The algorithm is the JAX
package's: candidates by the expansion distance ``|x|^2 - 2 x.y + |y|^2``,
k + slack of them, then an exact subtractive re-rank. Selection is a stable
sort (an argmin for a single candidate), so ties break to the lower index
as ``jax.lax.top_k`` does. ``approx=True`` keeps its larger slack; the JAX
selection it names (``approx_max_k``) is exact on the CPU, which is what
the parity tests hold this function to. ``rerank=False`` (with approx)
returns the candidate pass itself: the expansion distances, which callers
that only threshold distances consume. Queries are processed in chunks of
``query_chunk`` rows, which bounds the distance block's memory and does not
change the result.
"""

from __future__ import annotations

import torch

from ssf_slam_tpu_torch.ops.grouping import group_points

Tensor = torch.Tensor

_BIG = 1e10


def _sqnorm3(v: Tensor) -> Tensor:
    """Sum of squares over the last (xyz) axis, in a fixed order."""
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]


def pairwise_sqdist(x: Tensor, y: Tensor) -> Tensor:
    """Squared distances [..., N, M] by the expansion, clamped at 0."""
    x2, y2 = _sqnorm3(x)[..., :, None], _sqnorm3(y)[..., None, :]
    cross = torch.matmul(x, y.transpose(-1, -2))
    return torch.clamp(x2 - 2.0 * cross + y2, min=0.0)


def _smallest(d: Tensor, k: int) -> Tensor:
    """Indices of the k smallest along the last axis, ties to lower index."""
    if k == 1:
        return torch.argmin(d, dim=-1, keepdim=True)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def _masked(d: Tensor, valid: Tensor | None) -> Tensor:
    if valid is None:
        return d
    return torch.where(valid, d, torch.full_like(d, _BIG))


def _knn_chunk(query, points, k, points_mask, slack, rerank):
    d = _masked(pairwise_sqdist(query, points),
                None if points_mask is None else points_mask[..., None, :])
    cand = _smallest(d, k + slack)
    if not rerank:
        return torch.gather(d, -1, cand), cand
    d_exact = _sqnorm3(group_points(points, cand) - query[..., None, :])
    if points_mask is not None:
        mask = points_mask[..., None, :].expand(cand.shape[:-1]
                                                + points_mask.shape[-1:])
        d_exact = _masked(d_exact, torch.gather(mask, -1, cand))
    pos = _smallest(d_exact, k)
    return torch.gather(d_exact, -1, pos), torch.gather(cand, -1, pos)


def knn(query: Tensor, points: Tensor, k: int,
        points_mask: Tensor | None = None, query_chunk: int = 2048,
        approx: bool = False, rerank: bool = True) -> tuple[Tensor, Tensor]:
    """[..., N, 3] x [..., M, 3] -> (sqdist [..., N, k], idx [..., N, k])
    ascending by distance; idx is int64. Invalid points (``points_mask``
    False) are never chosen while valid ones remain; surplus slots carry
    distance 1e10. Every query gets a result; callers mask invalid ones."""
    m = points.shape[-2]
    if approx and not rerank:
        slack = 0
    else:
        slack = min(8 if approx else 4, m - k) if m > k else 0
    n = query.shape[-2]
    if n <= query_chunk:
        return _knn_chunk(query, points, k, points_mask, slack,
                          rerank or not approx)
    parts = [_knn_chunk(query[..., s:s + query_chunk, :], points, k,
                        points_mask, slack, rerank or not approx)
             for s in range(0, n, query_chunk)]
    return (torch.cat([p[0] for p in parts], dim=-2),
            torch.cat([p[1] for p in parts], dim=-2))


def nearest_neighbor(query: Tensor, points: Tensor,
                     points_mask: Tensor | None = None,
                     approx: bool = False) -> tuple[Tensor, Tensor]:
    """1-NN: ([..., N] sqdist, [..., N] index)."""
    d, i = knn(query, points, 1, points_mask=points_mask, approx=approx)
    return d[..., 0], i[..., 0]
