"""The property the query-split band selection of ``csrc/band_knn.cu``
(``knn_group_kernel``, which serves knn, knn_group and knn_group2, and
``knn_idw_kernel``) rests on, on the CPU.

The kernels split each query's band over S lanes: lane s keeps the k best
packed keys of band positions p = s (mod S), and k rounds of a minimum over
the lanes' heads merge the S lists. That gives the serial top-k exactly,
however the band is split, because a query's packed keys
(bits(d) & ~0x3FF) | p are distinct: p < 1024 sits in the low bits. A small
torch emulation of the split and the merge is held here, EXACTLY, to
``banded.knn_plain``'s sqdist and idx, on a Morton-sorted bench-like cloud,
a cloud of duplicated points (equal distances, ties broken by position)
and a cloud with padded rows past ``n_valid`` (1e10 keys told apart only by
position; a band of 5 valid rows, so that k > 5 takes the nearest-index
rule). knn_group2's twin search is emulated the same way: search b's keys
come from its own clouds (search a's, each point moved by a seeded 0.05 x
normal) under search a's plan, and both merged lists, with the rows they
group, are held EXACTLY to ``banded.knn_group2_plain``.
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

N, M = 1024, 2048
PARAMS = (256, 256, 3)
_INT_MAX = 0x7FFFFFFF


@functools.lru_cache(maxsize=None)
def _clouds(kind: str):
    """(query [1, N, 3], points [1, M, 3], plan) of one cloud kind."""
    frames = generate_sequence(n_frames=2, n_points=M, seed=3, noise=0.004,
                               n_moving=4)
    pts = np.stack([f["pos1"][:M] for f in frames]).astype(np.float32)
    if kind == "duplicated":  # every target point four times over
        pts[1] = np.repeat(pts[1, :M // 4], 4, axis=0)
    box = sequence_box(pts)
    q = nb.morton_sort(torch.from_numpy(pts[0:1, :N]), box=box)[0]
    p = nb.morton_sort(torch.from_numpy(pts[1:2]), box=box)[0]
    if kind == "duplicated":  # queries on target points: distance 0 ties
        q = nb.morton_sort(p[:, ::M // N].contiguous(), box=box)[0]
    b0, n_valid = nb.make_plan(q, p, PARAMS, 64.0, box)
    if kind == "padded":  # the last tile's band: 5 rows, then padding
        n_valid = int(b0.max()) * PARAMS[1] + 5
    return q, p, (b0, n_valid)


def _band_keys(query, points, plan) -> torch.Tensor:
    """[B, N, wb] int32 packed keys, as banded._band_topk_plain makes them."""
    b0, n_valid = plan
    qt, wblk, n_blocks = PARAMS
    wb = wblk * n_blocks
    bsz, n, _ = query.shape
    rows = banded._band_rows(b0, wblk, wb)
    band = torch.gather(points, 1, rows.reshape(bsz, -1, 1).expand(-1, -1, 3))
    band = band.view(bsz, n // qt, 1, wb, 3)
    q = query.view(bsz, n // qt, qt, 1, 3)
    d = banded._band_dist(q[..., 0] - band[..., 0], q[..., 1] - band[..., 1],
                          q[..., 2] - band[..., 2])
    d = torch.where(rows[:, :, None, :] < n_valid, d, banded._BIG)
    pos = torch.arange(wb, dtype=torch.int32)
    keys = (d.view(torch.int32) & ~banded._POS_MASK) | pos
    return keys.reshape(bsz, n, wb)


def _split_merge(keys: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """k smallest keys [B, N, k]: lane j of s keeps the k best of positions
    j (mod s); k rounds of a minimum over the lanes' heads, the winner
    popping its head."""
    bsz, n, wb = keys.shape
    lanes = torch.full((bsz, n, s, k), _INT_MAX, dtype=torch.int32)
    for j in range(s):
        own = torch.sort(keys[..., j::s], dim=-1).values[..., :k]
        lanes[..., j, :own.shape[-1]] = own
    head = torch.zeros(bsz, n, s, 1, dtype=torch.long)
    out = []
    for _ in range(k):
        heads = torch.gather(
            torch.cat([lanes, torch.full_like(lanes[..., :1], _INT_MAX)], -1),
            -1, head)[..., 0]
        m = heads.min(dim=-1).values
        won = heads == m[..., None]
        assert bool((won.sum(-1) == 1).all()), "two lanes hold one key"
        head += won[..., None].long()
        out.append(m)
    return torch.stack(out, -1)


def _unpack(merged: torch.Tensor, plan) -> tuple:
    """(sqdist, idx int32) of merged packed keys, as the kernels write
    them: overflow slots repeat the nearest position."""
    d = (merged & ~banded._POS_MASK).view(torch.float32)
    pos = merged & banded._POS_MASK
    pos = torch.where(d >= banded._BIG * 0.5, pos[..., :1], pos)
    base = torch.repeat_interleave(plan[0] * PARAMS[1], PARAMS[0], dim=1)
    return d, (pos + base[..., None]).to(torch.int32)


@pytest.mark.parametrize("kind", ["bench", "duplicated", "padded"])
def test_band_keys_are_distinct(kind):
    q, p, plan = _clouds(kind)
    keys = torch.sort(_band_keys(q, p, plan), dim=-1).values
    assert bool((keys[..., 1:] > keys[..., :-1]).all())


@pytest.mark.parametrize("k", [1, 7, 16, 32])
@pytest.mark.parametrize("s", [1, 8, 32])
@pytest.mark.parametrize("kind", ["bench", "duplicated", "padded"])
def test_split_merge_equals_knn_plain(kind, s, k):
    q, p, plan = _clouds(kind)
    d, idx = _unpack(_split_merge(_band_keys(q, p, plan), k, s), plan)
    want_d, want_i = banded.knn_plain(q, p, k, plan, PARAMS)
    assert torch.equal(d, want_d)
    assert torch.equal(idx, want_i)
    if kind == "padded" and k > 5:  # slots past the 5 valid rows
        assert bool((want_d >= banded._BIG * 0.5).any())
    if kind == "duplicated" and k > 1:  # equal distances in one list
        assert bool((want_d[..., 1:] == want_d[..., :-1]).any())


@pytest.mark.parametrize("k", [1, 16, 32])
@pytest.mark.parametrize("s", [1, 8, 32])
@pytest.mark.parametrize("kind", ["bench", "duplicated", "padded"])
def test_twin_split_merge_equals_knn_group2_plain(kind, s, k):
    qa, pa, plan = _clouds(kind)
    rng = np.random.default_rng(11)
    qb = qa + torch.from_numpy(
        0.05 * rng.standard_normal(qa.shape).astype(np.float32))
    pb = pa + torch.from_numpy(
        0.05 * rng.standard_normal(pa.shape).astype(np.float32))
    feats = torch.from_numpy(rng.standard_normal((1, M, 5))
                             .astype(np.float32))
    want = banded.knn_group2_plain(qa, qb, pa, pb, feats, k, plan, PARAMS)
    for (q, p), (want_d, want_i, want_g) in zip(((qa, pa), (qb, pb)),
                                                (want[:3], want[3:])):
        d, idx = _unpack(_split_merge(_band_keys(q, p, plan), k, s), plan)
        assert torch.equal(d, want_d)
        assert torch.equal(idx, want_i)
        assert torch.equal(feats[0][idx.long()], want_g)
    assert not torch.equal(want[1], want[4])  # the searches differ
