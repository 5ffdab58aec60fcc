"""Morton-banded neighbour engine: the band plan and the four banded
kernels that serving runs (ssf_slam_tpu_torch/ops/banded.py), plain
versions only.

Both clouds are Morton-sorted, so a query's true neighbours live in a
narrow band of the sorted target array. ``plan_bands`` gives every tile of
256 consecutive queries one band of ``n_blocks`` target blocks; the kernels
then only look inside that band. The plan decides which neighbours can
exist at all, so it is ported bit-exactly, and the 256-query tile is part
of the semantics.

The reference keeps only the plain PyTorch versions of those kernels (the
same packed-key top-k, the same distance truncation), on every device.

All tensors are batched: query [B, N, 3], points [B, M, 3] float32;
feats [B, M, C] float32 or bfloat16; idx [B, N, k] int32 absolute rows of
the sorted target array; plan = (b0 [B, N / 256] int32, n_valid int);
params = (query_tile, wblk, n_blocks) from ``neighbors.band_params``.
"""

from __future__ import annotations

import torch

from portbench.reference.plain.ops.morton import fma32, morton_codes

Tensor = torch.Tensor

QUERY_TILE = 256
_BIG = 1e10
_POS_BITS = 10
_POS_MASK = (1 << _POS_BITS) - 1
IDW_EPS = 1e-2  # ops/interp.py::idw_weights' eps, inside the sqrt

# ---------------------------------------------------------------------------
# band plan
# ---------------------------------------------------------------------------


def plan_bands(query: Tensor, points: Tensor, query_tile: int, wblk: int,
               n_blocks: int, extent: float = 64.0, box=None):
    """Band block indices of every query tile (banded.py::plan_bands).

    One representative query per tile (its middle element) is ranked
    against the block-boundary codes of the targets; the band starts
    ``n_blocks // 2`` blocks before the block that contains it, clipped to
    the array. ``box`` is (origin [B, 3], scale [B]).

    Returns (b0 [B, n_tiles] int32, n_valid int); every target is valid on
    the model path (no points mask).
    """
    m = points.shape[-2]
    if m % wblk or query.shape[-2] % query_tile:
        raise ValueError(f"shapes {tuple(query.shape)} x {tuple(points.shape)}"
                         f" do not tile by ({query_tile}, {wblk})")
    origin = scale = None
    if box is not None:
        origin, scale = box[0][..., None, :], box[1][..., None, None]
    qc = morton_codes(query[..., query_tile // 2::query_tile, :], extent,
                      origin, scale)
    bc = morton_codes(points[..., ::wblk, :], extent, origin, scale)
    contains = torch.sum(bc[..., None, :] <= qc[..., :, None], dim=-1) - 1
    b0 = torch.clamp(contains - n_blocks // 2, 0,
                     max(m // wblk - n_blocks, 0))
    return b0.to(torch.int32), m


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _band_dist(dx: Tensor, dy: Tensor, dz: Tensor) -> Tensor:
    """Squared distance with the reference's rounding.

    _pairwise_band_dist writes ((0 + dx*dx) + dy*dy) + dz*dz; XLA compiles
    it (on the CPU, where the parity tests run the Pallas kernel) into
    fma(dz, dz, fma(dx, dx, dy*dy)) — measured on every selected slot of
    the banded test fixture. The truncated distance and so the neighbour
    order at near-ties depend on these roundings, so the port computes
    exactly this; the CUDA kernel uses the same fused multiply-adds.
    """
    return fma32(dz, dz, fma32(dx, dx, dy * dy))


def _band_rows(b0: Tensor, wblk: int, wb: int) -> Tensor:
    """[B, T] block index -> [B, T, wb] absolute band rows."""
    pos = torch.arange(wb, device=b0.device)
    return b0.long()[..., None] * wblk + pos


def _band_topk_plain(query, points, plan, k, params):
    """The band top-k of _topk_band: (sqdist [B, N, k], idx [B, N, k] i32)."""
    b0, n_valid = plan
    qt, wblk, nb = params
    wb = wblk * nb
    bsz, n, _ = query.shape
    t = n // qt
    rows = _band_rows(b0, wblk, wb)  # [B, T, wb]
    band = torch.gather(points, 1, rows.reshape(bsz, -1, 1).expand(-1, -1, 3))
    band = band.view(bsz, t, 1, wb, 3)
    q = query.view(bsz, t, qt, 1, 3)
    dx = q[..., 0] - band[..., 0]
    dy = q[..., 1] - band[..., 1]
    dz = q[..., 2] - band[..., 2]
    d = _band_dist(dx, dy, dz)  # [B, T, qt, wb]
    d = torch.where(rows[:, :, None, :] < n_valid, d, _BIG)
    pos = torch.arange(wb, device=query.device, dtype=torch.int32)
    packed = (d.view(torch.int32) & ~_POS_MASK) | pos
    pk = torch.sort(packed, dim=-1).values[..., :k]
    dk = (pk & ~_POS_MASK).view(torch.float32)
    ik = pk & _POS_MASK
    # overflow slots repeat the nearest index (their distance stays big)
    ik = torch.where(dk >= _BIG * 0.5, ik[..., :1], ik)
    idx = ik + (b0 * wblk)[..., None, None]
    return dk.reshape(bsz, n, k), idx.reshape(bsz, n, k).to(torch.int32)


def _rows_of(feats: Tensor, idx: Tensor) -> Tensor:
    """feats [B, M, C], idx [B, N, k] -> [B, N, k, C]."""
    bsz, n, k = idx.shape
    flat = idx.long().reshape(bsz, n * k, 1).expand(-1, -1, feats.shape[-1])
    return torch.gather(feats, 1, flat).view(bsz, n, k, feats.shape[-1])


def _in_band(idx: Tensor, b0: Tensor, params) -> Tensor:
    """[B, N, k] bool: idx lies in its query tile's band."""
    qt, wblk, nb = params
    base = torch.repeat_interleave(b0.long() * wblk, qt, dim=1)[..., None]
    return (idx >= base) & (idx < base + wblk * nb)


def knn_group_plain(query, points, feats, k, plan, params):
    d, idx = _band_topk_plain(query, points, plan, k, params)
    return d, idx, _rows_of(feats, idx)


def knn_idw_plain(query, points, feats, k, plan, params):
    d, idx = _band_topk_plain(query, points, plan, k, params)
    w = 1.0 / torch.sqrt(torch.clamp(d, min=0.0) + IDW_EPS * IDW_EPS)
    s = w[..., 0]
    for j in range(1, k):
        s = s + w[..., j]
    w = w / s[..., None]
    rows = _rows_of(feats, idx).float()
    out = w[..., 0, None] * rows[..., 0, :]
    for j in range(1, k):  # slot order, as the kernel sums
        out = out + w[..., j, None] * rows[..., j, :]
    return out.to(feats.dtype), d, idx


def regroup_plain(idx, feats, plan, params):
    out = _rows_of(feats, idx)
    return torch.where(_in_band(idx, plan[0], params)[..., None], out,
                       torch.zeros((), dtype=feats.dtype, device=feats.device))


def scatter_softmax_sum_plain(idx, vals, w_shift, plan, params, n_out):
    bsz, n, k, c = vals.shape
    e = torch.exp(w_shift.float())
    aug = torch.cat([vals.float() * e[..., None], e[..., None]], dim=-1)
    if vals.dtype == torch.bfloat16:  # the TPU kernel's bf16 operands
        aug = aug.to(torch.bfloat16).float()
    keep = _in_band(idx, plan[0], params) & (idx < n_out)
    aug = aug * keep[..., None]
    rows = torch.where(keep, idx.long(), 0)
    out = torch.zeros(bsz, n_out, c + 1, dtype=torch.float32,
                      device=vals.device)
    for b in range(bsz):
        out[b].index_add_(0, rows[b].reshape(-1), aug[b].reshape(-1, c + 1))
    return out


# the reference runs the plain versions on every device
knn_group = knn_group_plain
knn_idw = knn_idw_plain
regroup = regroup_plain
scatter_softmax_sum = scatter_softmax_sum_plain
