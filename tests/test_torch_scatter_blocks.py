"""The block partitions of the banded scatter and regroup kernels
(``csrc/band_scatter.cu``: ``scatter_kernel``, ``regroup_kernel``), on the
CPU.

Scatter (scatter-add and softmax-sum, one body): a block of the kernel
takes one part of a query tile t (``parts`` parts of 256 / parts queries)
of one batch row and one slice of at most 64 value columns (32 lanes of
two; the softmax-sum's last slice also sums column C, e). It sorts the
part's entries whose index lies in the tile's band [base, base + wblk *
n_blocks), base = b0[t] * wblk, and below ``n_out``, by band row, splits
the sorted list into 16 warp ranges and sums each range row by row, adding
each row's nonzero sums into the zero-filled output. A small torch
emulation of that partition is held here to ``banded.scatter_add_plain``
and ``banded.scatter_softmax_sum_plain`` (float32 sums in another order:
within ``banded.scatter_add_slack`` / ``scatter_softmax_sum_slack``, their
rounding bound), and every entry that the plain version keeps (in its
tile's band, below n_out) is taken by exactly one block of each channel
slice, every other by none. Clouds: a Morton-sorted bench-like cloud with
its band plan; plans whose bands overlap unevenly, leave band blocks that
no tile reaches, and put every tile on one band; entries out of their
band; n_out below the target count. Parts 1, 2 and 8 (the kernel's range),
three channel slices (C = 150), values float32 and bf16.

Regroup: a warp copies 32 consecutive rows of out in units of VW bytes
(the widest power of two up to 16 that divides the row and both pointers'
offsets); unit x = lane + 32 s of the chunk is unit x % nv of row x / nv,
walked as the kernel walks it. The emulation, over the same plans, C = 35
and 64, float32 and bf16 and feats at an aligned offset and one element
past it, equals ``banded.regroup_plain`` exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from ssf_slam_tpu_torch.data.synthetic import generate_sequence
from ssf_slam_tpu_torch.engine.fused import sequence_box
from ssf_slam_tpu_torch.ops import banded
from ssf_slam_tpu_torch.ops import neighbors as nb

torch.set_num_threads(1)

N, M, K, C = 1024, 2048, 8, 150
WARPS = 16  # kScatterWarps


def slices_of(c: int, cl: int = 2) -> list[tuple[int, int]]:
    """The kernel's channel slices [(c0, w)]: as few as 32 lanes of cl
    channels allow, each a multiple of cl columns."""
    n = -(-c // (32 * cl))
    w = -(-c // n)
    w += -w % cl
    return [(c0, min(w, c - c0)) for c0 in range(0, c, w)]


def block_scatter(idx, vals, plan, params, n_out, parts, w_shift=None):
    """(out [B, n_out, C (+ 1)] float32, taken [B, N, k] int): the sums of
    the kernel's blocks, and how many blocks of the first channel slice
    took each entry; with ``w_shift``, the softmax-sum's terms [rnd(v e),
    rnd(e)] (e = exp(w_shift), rnd the bf16 round trip for bf16 values),
    the e column summed by the last slice."""
    b0 = plan[0]
    qt, wblk, n_blocks = params
    bsz, n, k, c = vals.shape
    terms = vals.float()
    if w_shift is not None:
        e = torch.exp(w_shift.float())
        terms = torch.cat([terms * e[..., None], e[..., None]], dim=-1)
        if vals.dtype == torch.bfloat16:
            terms = terms.to(torch.bfloat16).float()
    out = torch.zeros(bsz, n_out, terms.shape[-1])  # the caller's zero fill
    taken = torch.zeros(bsz, n, k, dtype=torch.int64)
    slices = slices_of(c)
    for b in range(bsz):
        for t in range(n // qt):
            base = int(b0[b, t]) * wblk
            rows = min(wblk * n_blocks, n_out - base)
            if rows <= 0:
                continue
            for p in range(parts):
                q = slice(t * qt + p * qt // parts,
                          t * qt + (p + 1) * qt // parts)
                i = idx[b, q].reshape(-1).long()
                hit = (i >= base) & (i - base < rows)
                taken[b, q] += hit.view(-1, k)  # once for each slice
                ent = torch.nonzero(hit)[:, 0]
                r = i[ent] - base
                order = torch.sort(r, stable=True).indices
                ent, r = ent[order], r[order]
                # the warp of each sorted position: range [H w / 16, H (w +
                # 1) / 16) of the H hits
                lo = torch.arange(WARPS + 1) * len(r) // WARPS
                wid = torch.searchsorted(lo, torch.arange(len(r)),
                                         right=True) - 1
                v = terms[b, q].reshape(-1, terms.shape[-1])[ent]
                for s, (c0, w) in enumerate(slices):
                    cols = slice(c0, c0 + w + (
                        1 if w_shift is not None and s == len(slices) - 1
                        else 0))
                    acc = torch.zeros(WARPS * rows, cols.stop - c0)
                    acc.index_add_(0, wid * rows + r, v[:, cols])
                    # each warp adds its nonzero row sums into out
                    at = torch.nonzero(acc != 0)
                    out[b].index_put_((base + at[:, 0] % rows, c0 + at[:, 1]),
                                      acc[at[:, 0], at[:, 1]],
                                      accumulate=True)
    return out, taken


@functools.lru_cache(maxsize=None)
def _bench():
    """(idx [1, N, K], plan) of a Morton-sorted bench-like pair."""
    frames = generate_sequence(n_frames=2, n_points=M, seed=3, noise=0.004,
                               n_moving=4)
    pts = np.stack([f["pos1"][:M] for f in frames]).astype(np.float32)
    box = sequence_box(pts)
    q = nb.morton_sort(torch.from_numpy(pts[0:1, :N]), box=box)[0]
    p = nb.morton_sort(torch.from_numpy(pts[1:2]), box=box)[0]
    params = (256, 256, 3)
    plan = nb.make_plan(q, p, params, 64.0, box)
    _, idx = banded.knn_plain(q, p, K, plan, params)
    return idx, plan


def _case(kind: str, wblk: int):
    """(idx [B, N, K] int32, plan, params, n_out) of one plan kind."""
    params = (256, wblk, 3)
    n_bands = M // wblk
    rng = np.random.default_rng(11)
    if kind in ("bench", "out_of_band", "n_out_below_m") and wblk == 256:
        idx, plan = _bench()
        idx = idx.clone()
    else:  # band starts from the kind, indices anywhere in [0, M)
        tiles = N // 256
        spread = np.arange(tiles) * (n_bands - 3) // (tiles - 1)
        b0 = {"uneven": np.array([0, 0, 3, n_bands - 3]),
              "unreached": np.zeros(tiles, np.int64),
              "all_reach": np.full(tiles, n_bands // 2 - 1)}.get(kind, spread)
        plan = (torch.from_numpy(np.stack([b0, b0[::-1].copy()]))
                .to(torch.int32), M)
        base = torch.repeat_interleave(plan[0].long() * wblk, 256, dim=1)
        idx = base[..., None] + torch.from_numpy(
            rng.integers(0, 3 * wblk, (2, N, K)))
        wild = torch.from_numpy(rng.random((2, N, K)) < 0.2)
        idx = torch.where(wild, torch.from_numpy(
            rng.integers(0, M, (2, N, K))), idx).to(torch.int32)
    if kind == "out_of_band":  # as tests/test_torch_cuda.py makes them
        idx[:, :256:37, 0] = M - 1
        idx[:, 300:310, 1] = 0
    n_out = 1500 if kind == "n_out_below_m" else M
    return idx, plan, params, n_out


KINDS = ["bench", "uneven", "unreached", "all_reach", "out_of_band",
         "n_out_below_m"]


def _check_blocks(kind, wblk, parts, dtype, softmax):
    idx, plan, params, n_out = _case(kind, wblk)
    bsz = idx.shape[0]
    assert len(slices_of(C)) == 3
    gen = torch.Generator().manual_seed(5)
    vals = torch.randn(bsz, N, K, C, generator=gen).to(getattr(torch, dtype))
    if softmax:
        w = torch.randn(bsz, N, K, generator=gen)
        w = w - w.max()
        got, taken = block_scatter(idx, vals, plan, params, n_out, parts, w)
        want = banded.scatter_softmax_sum_plain(idx, vals, w, plan, params,
                                                n_out)
        slack = banded.scatter_softmax_sum_slack(idx, vals, w, plan, params,
                                                 n_out)
    else:
        got, taken = block_scatter(idx, vals, plan, params, n_out, parts)
        want = banded.scatter_add_plain(idx, vals, plan, params, n_out)
        slack = banded.scatter_add_slack(idx, vals, plan, params, n_out)
    # float32 sums in another order: within their rounding bound
    assert got.shape == want.shape
    assert bool(((got.double() - want.double()).abs() <= slack).all())
    keep = banded._in_band(idx, plan[0], params) & (idx < n_out)
    assert torch.equal(taken, keep.long())
    # the kind does what it says
    beta = torch.arange(M // wblk)
    reach = ((plan[0][..., None] <= beta)
             & (beta < plan[0][..., None] + params[2])).sum(1)  # [B, bands]
    if kind == "unreached":
        assert bool((reach == 0).any())
        starts = (beta[None].expand(bsz, -1) * wblk)[reach == 0]
        assert bool((got[0, starts[starts < n_out]] == 0).all())
    if kind == "all_reach":
        assert int(reach.max()) == N // 256
    if kind in ("out_of_band", "uneven"):
        assert bool((~keep).any())
    if kind == "n_out_below_m":
        assert bool((idx >= n_out).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parts", [1, 2, 8])
@pytest.mark.parametrize("wblk", [256, 128])
@pytest.mark.parametrize("kind", KINDS)
def test_blocks_equal_scatter_add_plain(kind, wblk, parts, dtype):
    _check_blocks(kind, wblk, parts, dtype, softmax=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parts", [1, 2, 8])
@pytest.mark.parametrize("wblk", [256, 128])
@pytest.mark.parametrize("kind", KINDS)
def test_blocks_equal_scatter_softmax_sum_plain(kind, wblk, parts, dtype):
    _check_blocks(kind, wblk, parts, dtype, softmax=True)


def block_regroup(idx, feats, plan, params, offset: int):
    """out [B, N, k, C]: the kernel's warps, each copying a chunk of 32
    rows in units of VW bytes, with feats ``offset`` elements past an
    aligned address (out is aligned)."""
    qt, wblk, n_blocks = params
    bsz, n, k = idx.shape
    m, c = feats.shape[1:]
    row_bytes = c * feats.element_size()
    align = row_bytes | offset * feats.element_size() | 16
    vw = align & -align  # the widest unit dividing both
    nv = row_bytes // vw
    units = feats.contiguous().view(torch.uint8).reshape(bsz * m * nv, vw)
    chunks = bsz * n * k // 32
    e0 = torch.arange(chunks) * 32
    bt = e0 // (qt * k)  # b * tiles + t
    b = bt // (n // qt)
    base = (plan[0].reshape(-1)[bt].long() * wblk)[:, None]
    i = idx.reshape(chunks, 32).long()
    src = torch.where((i >= base) & (i - base < wblk * n_blocks) & (i < m),
                      b[:, None] * m + i, -1)  # [chunks, lanes]
    lane = torch.arange(32)
    q, u = lane // nv, lane % nv
    dq, du = 32 // nv, 32 - (32 // nv) * nv
    out = torch.zeros(chunks * 32 * nv, vw, dtype=torch.uint8)
    for s in range(nv):
        r = src[:, q % 32]  # the shuffle from lane q
        got = torch.where((r >= 0)[..., None], units[(r * nv + u).clamp(
            min=0)], torch.zeros((), dtype=torch.uint8))
        out[(e0[:, None] * nv + lane + 32 * s).reshape(-1)] = got.reshape(
            -1, vw)
        u, q = u + du, q + dq
        q, u = torch.where(u >= nv, q + 1, q), torch.where(u >= nv, u - nv, u)
    return out.view(feats.dtype).reshape(bsz, n, k, c)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [35, 64])
@pytest.mark.parametrize("wblk", [256, 128])
@pytest.mark.parametrize("kind", KINDS)
def test_regroup_units_equal_regroup_plain(kind, wblk, c, dtype, offset):
    idx, plan, params, _ = _case(kind, wblk)
    feats = torch.from_numpy(np.random.default_rng(c).normal(
        size=(idx.shape[0], M, c)).astype(np.float32)).to(getattr(torch,
                                                                  dtype))
    got = block_regroup(idx, feats, plan, params, offset)
    want = banded.regroup_plain(idx, feats, plan, params)
    assert torch.equal(got, want)
    if kind in ("out_of_band", "uneven"):
        assert bool((got[~banded._in_band(idx, plan[0], params)] == 0).all())
