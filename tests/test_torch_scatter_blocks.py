"""The block partition of the banded scatter-add kernel
(``csrc/band_scatter.cu``, ``scatter_add_kernel``), on the CPU.

A block of the kernel takes one part of a query tile t (``parts`` parts of
256 / parts queries) of one batch row and one slice of at most 32 channels.
It sums the part's entries whose index lies in the tile's band [base, base +
wblk * n_blocks), base = b0[t] * wblk, and below ``n_out``, into a band
accumulator, then adds the accumulator's nonzero sums into the zero-filled
output. A small torch emulation of that partition is held here to
``banded.scatter_add_plain`` (float32 sums in another order: within
``banded.scatter_add_slack``, their rounding bound), and
every entry that the plain version keeps (in its tile's band, below n_out)
is taken by exactly one block of each channel slice, every other by none.
Clouds: a Morton-sorted bench-like cloud with its band plan; plans whose
bands overlap unevenly, leave band blocks that no tile reaches, and put
every tile on one band; entries out of their band; n_out below the target
count. Parts 1, 2 and 8 (the kernel's range), three channel slices, values
float32 and bf16.
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

N, M, K, C = 1024, 2048, 8, 70


def slices_of(c: int, band: int) -> list[tuple[int, int]]:
    """The kernel's channel slices [(c0, w)]: as few as one channel a lane
    allows, with the accumulator at most 768 x 32 float32."""
    max_w = min(32, 768 * 32 // band)
    n = -(-c // max_w)
    w = -(-c // n)
    return [(c0, min(w, c - c0)) for c0 in range(0, c, w)]


def block_scatter(idx, vals, plan, params, n_out, parts):
    """(out [B, n_out, C] float32, taken [B, N, k] int): the sums of the
    kernel's blocks, and how many blocks of the first channel slice took
    each entry."""
    b0 = plan[0]
    qt, wblk, n_blocks = params
    bsz, n, k, c = vals.shape
    band = wblk * n_blocks
    out = torch.zeros(bsz, n_out, c)  # the caller's zero fill
    taken = torch.zeros(bsz, n, k, dtype=torch.int64)
    for b in range(bsz):
        for t in range(n // qt):
            base = int(b0[b, t]) * wblk
            rows = min(band, n_out - base)
            if rows <= 0:
                continue
            for p in range(parts):
                q = slice(t * qt + p * qt // parts,
                          t * qt + (p + 1) * qt // parts)
                i = idx[b, q].long()
                hit = (i >= base) & (i - base < rows)
                for c0, w in slices_of(c, band):
                    if c0 == 0:
                        taken[b, q] += hit
                    acc = torch.zeros(rows, w)
                    acc.index_add_(0, i[hit] - base,
                                   vals[b, q][hit][:, c0:c0 + w].float())
                    nz = acc != 0  # the kernel adds only the nonzero sums
                    out[b, base:base + rows, c0:c0 + w][nz] += acc[nz]
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parts", [1, 2, 8])
@pytest.mark.parametrize("wblk", [256, 128])
@pytest.mark.parametrize("kind", KINDS)
def test_blocks_equal_scatter_add_plain(kind, wblk, parts, dtype):
    idx, plan, params, n_out = _case(kind, wblk)
    bsz = idx.shape[0]
    assert len(slices_of(C, wblk * params[2])) == 3
    gen = torch.Generator().manual_seed(5)
    vals = torch.randn(bsz, N, K, C, generator=gen).to(getattr(torch, dtype))
    got, taken = block_scatter(idx, vals, plan, params, n_out, parts)
    want = banded.scatter_add_plain(idx, vals, plan, params, n_out)
    # float32 sums in another order: within their rounding bound
    slack = banded.scatter_add_slack(idx, vals, plan, params, n_out)
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
