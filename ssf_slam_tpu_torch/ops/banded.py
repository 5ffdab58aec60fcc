"""Morton-banded neighbour engine: the band plan and the seven banded
kernels (ssf_slam_tpu/ops/banded.py).

Both clouds are Morton-sorted, so a query's true neighbours live in a
narrow band of the sorted target array. ``plan_bands`` gives every tile of
256 consecutive queries one band of ``n_blocks`` target blocks; the kernels
then only look inside that band. The plan decides which neighbours can
exist at all, so it is ported bit-exactly, and the 256-query tile is part
of the semantics.

Each kernel has two versions behind one wrapper:
- a CUDA kernel (``csrc/band_knn.cu``: knn, knn_group, knn_group2,
  knn_idw; ``csrc/band_scatter.cu``: regroup, scatter_add,
  scatter_softmax_sum), launched for CUDA tensors on PyTorch's current
  stream;
- a plain PyTorch version computing the same function (the same packed-key
  top-k, the same distance truncation, the same bf16 rounding), taken only
  for CPU tensors. A CUDA tensor launches the kernel or raises: there is no
  fall back.

``LAUNCHES`` counts kernel launches per wrapper; the plain versions do not
count.

All tensors are batched: query [B, N, 3], points [B, M, 3] float32;
feats [B, M, C] float32 or bfloat16; idx [B, N, k] int32 absolute rows of
the sorted target array; plan = (b0 [B, N / 256] int32, n_valid int);
params = (query_tile, wblk, n_blocks) from ``neighbors.band_params``.
"""

from __future__ import annotations

import torch

from ssf_slam_tpu_torch.ops.morton import morton_codes

Tensor = torch.Tensor

QUERY_TILE = 256
_BIG = 1e10
_POS_BITS = 10
_POS_MASK = (1 << _POS_BITS) - 1
IDW_EPS = 1e-2  # ops/interp.py::idw_weights' eps, inside the sqrt

LAUNCHES = {"knn": 0, "knn_group": 0, "knn_group2": 0, "knn_idw": 0,
            "regroup": 0, "scatter_add": 0, "scatter_softmax_sum": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """float32 fused multiply-add, round(a * b + c): the float32 product is
    exact in float64, so only the sum rounds (then once more to float32)."""
    return (a.double() * b.double() + c.double()).float()


def _band_dist(dx: Tensor, dy: Tensor, dz: Tensor) -> Tensor:
    """Squared distance with the reference's rounding.

    _pairwise_band_dist writes ((0 + dx*dx) + dy*dy) + dz*dz; XLA compiles
    it (on the CPU, where the parity tests run the Pallas kernel) into
    fma(dz, dz, fma(dx, dx, dy*dy)) — measured on every selected slot of
    the banded test fixture. The truncated distance and so the neighbour
    order at near-ties depend on these roundings, so the port computes
    exactly this; the CUDA kernel uses the same fused multiply-adds.
    """
    return _fma(dz, dz, _fma(dx, dx, dy * dy))


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


def knn_plain(query, points, k, plan, params):
    return _band_topk_plain(query, points, plan, k, params)


def knn_group_plain(query, points, feats, k, plan, params):
    d, idx = _band_topk_plain(query, points, plan, k, params)
    return d, idx, _rows_of(feats, idx)


def knn_group2_plain(query_a, query_b, points_a, points_b, feats, k, plan,
                     params):
    da, ia, ga = knn_group_plain(query_a, points_a, feats, k, plan, params)
    db, ib, gb = knn_group_plain(query_b, points_b, feats, k, plan, params)
    return da, ia, ga, db, ib, gb


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


def scatter_add_plain(idx, vals, plan, params, n_out):
    bsz, n, k, c = vals.shape
    keep = _in_band(idx, plan[0], params) & (idx < n_out)
    v = torch.where(keep[..., None], vals.float(), 0.0)
    rows = torch.where(keep, idx.long(), 0)
    out = torch.zeros(bsz, n_out, c, dtype=torch.float32, device=vals.device)
    for b in range(bsz):
        out[b].index_add_(0, rows[b].reshape(-1), v[b].reshape(-1, c))
    return out


def scatter_softmax_sum_plain(idx, vals, w_shift, plan, params, n_out):
    bsz, n, k, c = vals.shape
    e = torch.exp(w_shift.float())
    aug = torch.cat([vals.float() * e[..., None], e[..., None]], dim=-1)
    if vals.dtype == torch.bfloat16:  # the TPU kernel's bf16 operands
        aug = aug.to(torch.bfloat16).float()
    aug = aug * _in_band(idx, plan[0], params)[..., None]
    out = torch.zeros(bsz, n_out, c + 1, dtype=torch.float32,
                      device=vals.device)
    for b in range(bsz):
        out[b].index_add_(0, idx[b].reshape(-1).long(),
                          aug[b].reshape(-1, c + 1))
    return out


# ---------------------------------------------------------------------------
# wrappers: CUDA tensors launch the kernel, CPU tensors take the plain version
# ---------------------------------------------------------------------------


def _on_cuda(*tensors: Tensor) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check(t: Tensor, name: str, dtypes, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_FEAT_TYPES = (torch.float32, torch.bfloat16)


def _check_geometry(query, points, feats, plan, k, params):
    _check(query, "query", (torch.float32,), 3)
    _check(points, "points", (torch.float32,), 3)
    _check(feats, "feats", _FEAT_TYPES, 3)
    _check(plan[0], "b0", (torch.int32,), 2)
    qt, wblk, nb = params
    bsz, n, _ = query.shape
    if (query.shape[-1] != 3 or points.shape[-1] != 3
            or points.shape[0] != bsz or feats.shape[:2] != points.shape[:2]
            or plan[0].shape != (bsz, n // qt) or qt != QUERY_TILE
            or n % qt or not 1 <= k <= 32 or wblk * nb > 1 << _POS_BITS):
        raise ValueError("banded kNN: inconsistent shapes or params")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def knn(query, points, k, plan, params):
    """Banded kNN (banded.py::banded_knn): (sqdist [B, N, k] f32,
    idx [B, N, k] i32), the top-k of ``knn_group`` without the grouping."""
    if not _on_cuda(query, points, plan[0]):
        return knn_plain(query, points, k, plan, params)
    _check_geometry(query, points, points, plan, k, params)
    from ssf_slam_tpu_torch.ops import cuda_build

    bsz, n, _ = query.shape
    m = points.shape[1]
    d = torch.empty(bsz, n, k, dtype=torch.float32, device=query.device)
    idx = torch.empty(bsz, n, k, dtype=torch.int32, device=query.device)
    cuda_build.call(
        "ssf_band_knn", "ssf_knn", query.data_ptr(), points.data_ptr(),
        plan[0].data_ptr(), bsz, n, m, k, params[1], params[2], int(plan[1]),
        d.data_ptr(), idx.data_ptr(), _stream())
    LAUNCHES["knn"] += 1
    return d, idx


def knn_group(query, points, feats, k, plan, params):
    """Fused banded kNN + grouping (banded.py::banded_knn_group).

    Returns (sqdist [B, N, k] f32, idx [B, N, k] i32,
    grouped [B, N, k, C] = feats[idx] in the feats type).
    """
    if not _on_cuda(query, points, feats, plan[0]):
        return knn_group_plain(query, points, feats, k, plan, params)
    _check_geometry(query, points, feats, plan, k, params)
    from ssf_slam_tpu_torch.ops import cuda_build

    bsz, n, _ = query.shape
    m, c = feats.shape[1], feats.shape[2]
    d = torch.empty(bsz, n, k, dtype=torch.float32, device=query.device)
    idx = torch.empty(bsz, n, k, dtype=torch.int32, device=query.device)
    grouped = torch.empty(bsz, n, k, c, dtype=feats.dtype, device=feats.device)
    cuda_build.call(
        "ssf_band_knn", "ssf_knn_group", query.data_ptr(), points.data_ptr(),
        feats.data_ptr(), plan[0].data_ptr(), bsz, n, m, c, k, params[1],
        params[2], int(plan[1]), int(feats.dtype == torch.bfloat16),
        d.data_ptr(), idx.data_ptr(), grouped.data_ptr(), _stream())
    LAUNCHES["knn_group"] += 1
    return d, idx, grouped


def knn_group2(query_a, query_b, points_a, points_b, feats, k, plan, params):
    """Twin banded kNN + grouping under ONE plan, made from (query_a,
    points_a), with feats shared (banded.py::banded_knn_group2). Returns
    (d_a, i_a, grouped_a, d_b, i_b, grouped_b), each as ``knn_group``'s."""
    if not _on_cuda(query_a, query_b, points_a, points_b, feats, plan[0]):
        return knn_group2_plain(query_a, query_b, points_a, points_b, feats,
                                k, plan, params)
    _check_geometry(query_a, points_a, feats, plan, k, params)
    _check_geometry(query_b, points_b, feats, plan, k, params)
    if query_b.shape != query_a.shape or points_b.shape != points_a.shape:
        raise ValueError("banded kNN group2: the twin searches differ in "
                         "shape")
    from ssf_slam_tpu_torch.ops import cuda_build

    bsz, n, _ = query_a.shape
    m, c = feats.shape[1], feats.shape[2]
    dev = query_a.device
    outs = []
    for _ in range(2):
        outs += [torch.empty(bsz, n, k, dtype=torch.float32, device=dev),
                 torch.empty(bsz, n, k, dtype=torch.int32, device=dev),
                 torch.empty(bsz, n, k, c, dtype=feats.dtype, device=dev)]
    cuda_build.call(
        "ssf_band_knn", "ssf_knn_group2", query_a.data_ptr(),
        query_b.data_ptr(), points_a.data_ptr(), points_b.data_ptr(),
        feats.data_ptr(), plan[0].data_ptr(), bsz, n, m, c, k, params[1],
        params[2], int(plan[1]), int(feats.dtype == torch.bfloat16),
        *(t.data_ptr() for t in outs), _stream())
    LAUNCHES["knn_group2"] += 1
    return tuple(outs)


def knn_idw(query, points, feats, k, plan, params):
    """Fused banded kNN + inverse-distance interpolation
    (banded.py::banded_knn_idw).

    Returns (out [B, N, C] in the feats type, sqdist [B, N, k] f32,
    idx [B, N, k] i32).
    """
    if not _on_cuda(query, points, feats, plan[0]):
        return knn_idw_plain(query, points, feats, k, plan, params)
    _check_geometry(query, points, feats, plan, k, params)
    from ssf_slam_tpu_torch.ops import cuda_build

    bsz, n, _ = query.shape
    m, c = feats.shape[1], feats.shape[2]
    out = torch.empty(bsz, n, c, dtype=feats.dtype, device=feats.device)
    d = torch.empty(bsz, n, k, dtype=torch.float32, device=query.device)
    idx = torch.empty(bsz, n, k, dtype=torch.int32, device=query.device)
    cuda_build.call(
        "ssf_band_knn", "ssf_knn_idw", query.data_ptr(), points.data_ptr(),
        feats.data_ptr(), plan[0].data_ptr(), bsz, n, m, c, k, params[1],
        params[2], int(plan[1]), IDW_EPS * IDW_EPS,
        int(feats.dtype == torch.bfloat16), out.data_ptr(), d.data_ptr(),
        idx.data_ptr(), _stream())
    LAUNCHES["knn_idw"] += 1
    return out, d, idx


def regroup(idx, feats, plan, params):
    """Grouping by banded indices (banded.py::banded_regroup):
    out[b, i, j] = feats[b, idx[b, i, j]], zeros where idx lies outside its
    tile's band."""
    if not _on_cuda(idx, feats, plan[0]):
        return regroup_plain(idx, feats, plan, params)
    _check(idx, "idx", (torch.int32,), 3)
    _check(feats, "feats", _FEAT_TYPES, 3)
    _check(plan[0], "b0", (torch.int32,), 2)
    bsz, n, k = idx.shape
    m, c = feats.shape[1], feats.shape[2]
    if (feats.shape[0] != bsz or n % QUERY_TILE or params[0] != QUERY_TILE
            or plan[0].shape != (bsz, n // QUERY_TILE)):
        raise ValueError("banded regroup: inconsistent shapes or params")
    from ssf_slam_tpu_torch.ops import cuda_build

    out = torch.empty(bsz, n, k, c, dtype=feats.dtype, device=feats.device)
    cuda_build.call(
        "ssf_band_scatter", "ssf_regroup", idx.data_ptr(), feats.data_ptr(),
        plan[0].data_ptr(), bsz, n, m, c, k, params[1], params[2],
        int(feats.dtype == torch.bfloat16), out.data_ptr(), _stream())
    LAUNCHES["regroup"] += 1
    return out


def scatter_add(idx, vals, plan, params, n_out):
    """Banded segment sum (banded.py::banded_scatter_add):
    out[b, m] = sum of vals[b, i, j] over idx[b, i, j] == m, in float32
    [B, n_out, C]; contributions whose idx lies outside its tile's band add
    nothing."""
    if not _on_cuda(idx, vals, plan[0]):
        return scatter_add_plain(idx, vals, plan, params, n_out)
    _check(idx, "idx", (torch.int32,), 3)
    _check(vals, "vals", _FEAT_TYPES, 4)
    _check(plan[0], "b0", (torch.int32,), 2)
    bsz, n, k = idx.shape
    c = vals.shape[-1]
    if (vals.shape[:3] != idx.shape or n % QUERY_TILE
            or params[0] != QUERY_TILE
            or plan[0].shape != (bsz, n // QUERY_TILE)):
        raise ValueError("banded scatter-add: inconsistent shapes or params")
    from ssf_slam_tpu_torch.ops import cuda_build

    out = torch.zeros(bsz, n_out, c, dtype=torch.float32, device=vals.device)
    cuda_build.call(
        "ssf_band_scatter", "ssf_scatter_add", idx.data_ptr(), vals.data_ptr(),
        plan[0].data_ptr(), bsz, n, c, k, n_out, params[1], params[2],
        int(vals.dtype == torch.bfloat16), out.data_ptr(), _stream())
    LAUNCHES["scatter_add"] += 1
    return out


def scatter_softmax_sum(idx, vals, w_shift, plan, params, n_out):
    """Banded scatter of [vals * e^w, e^w] (banded.py::
    banded_scatter_softmax_sum) -> f32 [B, n_out, C + 1]; ``w_shift`` is
    already max-shifted, the caller divides by the last column."""
    if not _on_cuda(idx, vals, w_shift, plan[0]):
        return scatter_softmax_sum_plain(idx, vals, w_shift, plan, params,
                                         n_out)
    _check(idx, "idx", (torch.int32,), 3)
    _check(vals, "vals", _FEAT_TYPES, 4)
    _check(w_shift, "w_shift", (torch.float32,), 3)
    _check(plan[0], "b0", (torch.int32,), 2)
    bsz, n, k = idx.shape
    c = vals.shape[-1]
    if (vals.shape[:3] != idx.shape or w_shift.shape != idx.shape
            or n % QUERY_TILE or params[0] != QUERY_TILE
            or plan[0].shape != (bsz, n // QUERY_TILE)):
        raise ValueError("banded scatter: inconsistent shapes or params")
    from ssf_slam_tpu_torch.ops import cuda_build

    out = torch.zeros(bsz, n_out, c + 1, dtype=torch.float32,
                      device=vals.device)
    cuda_build.call(
        "ssf_band_scatter", "ssf_scatter_softmax_sum", idx.data_ptr(),
        vals.data_ptr(), w_shift.data_ptr(), plan[0].data_ptr(), bsz, n, c, k,
        n_out, params[1], params[2], int(vals.dtype == torch.bfloat16),
        out.data_ptr(), _stream())
    LAUNCHES["scatter_softmax_sum"] += 1
    return out
