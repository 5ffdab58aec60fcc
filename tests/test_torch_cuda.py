"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; where CUDA is absent they skip.
The file imports no JAX (the card's machine has none), so it runs there
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Inputs: Morton-sorted lidar-like clouds (B=2, N=1024, M=2048, C=16) from a
numpy seed. knn_group and knn_idw (the query-split kernels) run over 1,024
and 8,192 queries at batch 1 and 4, so that the split the library picks
by query count takes each of its values (knn_group 32, 32, 16, 8 lanes per
query; knn_idw 32, 16, 8, 8), over every k in SPLIT_K, a 768- and a
384-row band (M = 2048 and 512), three clouds (lidar-like; padded rows
past n_valid, whose 1e10 keys differ only by position; duplicated points,
whose equal distances break ties by position) and float32 and bf16 feats
of C = 35, 99, 131 and 132; chip_smoke.py holds each S at the main path's
shapes through measurement builds that fix it.
knn and knn_group2 (the same selection body: knn with no grouping,
knn_group2 two searches in one launch, search b's clouds a warped copy of
search a's under search a's plan) run over the same cases.
Tolerances: sqdist, idx, grouped (knn_group and knn_group2's
twin searches), knn's and regroup EXACT; knn_idw's output float32 1e-5
relative + 1e-6 absolute (the same float32 operations, so in practice
equal), bf16 within one bf16 rounding step (2^-8 relative + 1e-6), as
chip_smoke.py holds it; scatter_softmax_sum and scatter_add 1e-5 relative +
1e-6 absolute, for the float32 atomics' run-to-run order (so is the grouping
backward through scatter_add against its plain version); scatter_add also
at batch 1 and 4, C = 35, 99, 260, band blocks of 256 and 128 rows, over
plans that overlap unevenly, leave band blocks unreached or put every tile
on one band, with entries out of band and n_out below M, within the same
tolerance beyond the rounding bound of two float32 sums in different
orders (banded.scatter_add_slack: sums of up to ~80 terms cancel there);
regroup (exact) and scatter_softmax_sum (within the same tolerance beyond
banded.scatter_softmax_sum_slack) over the same plans, batches and band
blocks at C = 35, 64, 131, with feats or values at an aligned address and
one element past it (so that the kernels' narrower units and loads run);
attention ([517] and [2, 517] points of K = 16, 9, 32, 20 rows and C =
64, 32, 128, 99, 200 channels; bf16 with C <= 128 on the tensor-core body,
the rest on the CUDA-core body): float32 within 1e-5, bf16 within one bf16
step on 99.99 % and two steps of (|value| + rms) everywhere, and its
gradient equal to attention_xla's. cost_attention (patches from a seed,
[2, N, K, C] with C2 hidden units: the main path's N = 8192 and 2048 at
K = 16, C = 64, C2 = 32, and padded shapes, K = 5 and 32, C = 35 and 128,
C2 = 17 and 64): float32 within 1e-4 (sum orders); bf16 cost_fwd
within one bf16 step of its value on 99.99 % of the elements and within two
steps of (|value| + rms) everywhere, w_k within 1e-3 on 99.99 % and 4e-3
everywhere (chip_smoke.py's COST_ATTENTION_TOL explains the rounding flips
behind these, and leaves more room for its network-made inputs, which vary
from run to run). The bf16 cost_attention kernel takes its rounded sums in
the orders that the plain version's library calls use on the card;
test_cuda_plain_sum_orders checks those orders by themselves, so that a
library update that changes them fails there by name.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from ssf_slam_tpu_torch.ops import attention, banded
from ssf_slam_tpu_torch.ops import neighbors as nb

B, N, M, K, C = 2, 1024, 2048, 8, 16
PARAMS = (256, 256, 3)


def _lidar_cloud(rng, n):
    r = rng.uniform(3, 28, n)
    th = rng.uniform(0, 2 * np.pi, n)
    z = rng.normal(0, 1.5, n)
    return np.stack([r * np.cos(th), r * np.sin(th), z], 1).astype(np.float32)


@pytest.fixture
def case():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    q0 = torch.from_numpy(np.stack([_lidar_cloud(rng, N) for _ in range(B)]))
    p0 = torch.from_numpy(np.stack([_lidar_cloud(rng, M) for _ in range(B)]))
    q0, p0 = q0.to(dev), p0.to(dev)
    box = nb.cloud_box(q0, p0)
    q, _ = nb.morton_sort(q0, box=box)
    p, _ = nb.morton_sort(p0, box=box)
    feats = torch.from_numpy(rng.normal(size=(B, M, C)).astype(np.float32))
    return dict(q=q, p=p, feats=feats.to(dev),
                plan=nb.make_plan(q, p, PARAMS, 64.0, box))


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _split_case(n, bsz, params, cloud):
    """(query [bsz, n, 3], points [bsz, M, 3], plan) on the card: M = 2048
    for a 768-row band, 512 for a 384-row one (su1's 2048 <- 512)."""
    rng = np.random.default_rng(5)
    m = 2048 if params[1] == 256 else 512
    q0 = np.stack([_lidar_cloud(rng, n) for _ in range(bsz)])
    p0 = np.stack([_lidar_cloud(rng, m) for _ in range(bsz)])
    if cloud == "duplicated":  # each target four times, queries on them
        p0 = np.repeat(p0[:, :m // 4], 4, axis=1)
        q0 = p0[:, rng.integers(0, m, n)]
    q0, p0 = torch.from_numpy(q0).cuda(), torch.from_numpy(p0).cuda()
    box = nb.cloud_box(q0, p0)
    q, _ = nb.morton_sort(q0, box=box)
    p, _ = nb.morton_sort(p0, box=box)
    plan = nb.make_plan(q, p, params, 64.0, box)
    if cloud == "padded":  # rows past n_valid; one band of 5 valid rows
        plan = (plan[0], int(plan[0][0].max()) * params[1] + 5)
    return q, p, plan


def _split_feats(bsz, m, dtype, c):
    f = np.random.default_rng(c).normal(size=(bsz, m, c)).astype(np.float32)
    return torch.from_numpy(f).cuda().to(getattr(torch, dtype))


SPLIT_K = [1, 3, 5, 7, 16, 32]
SPLIT_N = [1024, 8192]
SPLIT_PARAMS = [(256, 256, 3), (256, 128, 3)]
SPLIT_CLOUDS = ["lidar", "padded", "duplicated"]
SPLIT_FEATS = [(dtype, c) for c in (35, 99, 131, 132)
               for dtype in ("float32", "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("feats", SPLIT_FEATS)
@pytest.mark.parametrize("cloud", SPLIT_CLOUDS)
@pytest.mark.parametrize("bsz", [1, 4])
@pytest.mark.parametrize("n", SPLIT_N)
@pytest.mark.parametrize("params", SPLIT_PARAMS)
@pytest.mark.parametrize("k", SPLIT_K)
def test_cuda_knn_group_matches_plain(cuda_dev, k, params, n, bsz, cloud,
                                      feats):
    q, p, plan = _split_case(n, bsz, params, cloud)
    f = _split_feats(bsz, p.shape[1], *feats)
    want = banded.knn_group_plain(q, p, f, k, plan, params)
    before = banded.LAUNCHES["knn_group"]
    got = banded.knn_group(q, p, f, k, plan, params)
    assert banded.LAUNCHES["knn_group"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if cloud == "padded" and k > 5:  # slots past the band's 5 valid rows
        assert bool((want[0] >= 5e9).any())


@pytest.mark.cuda
@pytest.mark.parametrize("feats", SPLIT_FEATS)
@pytest.mark.parametrize("cloud", SPLIT_CLOUDS)
@pytest.mark.parametrize("bsz", [1, 4])
@pytest.mark.parametrize("n", SPLIT_N)
@pytest.mark.parametrize("params", SPLIT_PARAMS)
@pytest.mark.parametrize("k", SPLIT_K)
def test_cuda_knn_idw_matches_plain(cuda_dev, k, params, n, bsz, cloud,
                                    feats):
    q, p, plan = _split_case(n, bsz, params, cloud)
    f = _split_feats(bsz, p.shape[1], *feats)
    want = banded.knn_idw_plain(q, p, f, k, plan, params)
    before = banded.LAUNCHES["knn_idw"]
    got = banded.knn_idw(q, p, f, k, plan, params)
    assert banded.LAUNCHES["knn_idw"] == before + 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[0].dtype == f.dtype
    if feats[0] == "float32":
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    else:  # one bf16 rounding step, as chip_smoke.py holds it
        err = (got[0].float() - want[0].float()).abs()
        assert bool((err <= 1e-6 + 2.0 ** -8 * want[0].float().abs()).all())


@pytest.mark.cuda
def test_cuda_regroup_and_scatter_match_plain(case):
    c = case
    _, idx, _ = banded.knn_group(c["q"], c["p"], c["feats"], K, c["plan"],
                                 PARAMS)
    idx[:, :256:37, 0] = M - 1  # out of the first tile's band
    g = banded.regroup(idx, c["feats"], c["plan"], PARAMS)
    assert torch.equal(g, banded.regroup_plain(idx, c["feats"], c["plan"],
                                               PARAMS))
    assert bool((g[:, :256:37, 0] == 0).all())
    gen = torch.Generator(device="cuda").manual_seed(0)
    vals = torch.randn(B, N, K, C, device="cuda", generator=gen)
    w = torch.randn(B, N, K, device="cuda", generator=gen)
    w = w - w.max()
    for v in (vals, vals.to(torch.bfloat16)):
        got = banded.scatter_softmax_sum(idx, v, w, c["plan"], PARAMS, M)
        want = banded.scatter_softmax_sum_plain(idx, v, w, c["plan"], PARAMS,
                                                M)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(case):
    c = case
    with pytest.raises(TypeError):
        banded.knn_group(c["q"], c["p"], c["feats"].double(), K, c["plan"],
                         PARAMS)
    with pytest.raises(ValueError):  # a tile count the plan does not have
        banded.knn_group(c["q"][:, :512], c["p"], c["feats"], K, c["plan"],
                         PARAMS)
    with pytest.raises(ValueError):  # mixed devices
        banded.regroup(c["plan"][0].cpu().reshape(B, -1, 1).expand(
            -1, -1, K).contiguous(), c["feats"], c["plan"], PARAMS)


# (N, K, C, C2): the first test's shape, the main path's two launches
# (flow0_r at 8192 points, flow1_r at 2048) and shapes the kernel pads
# (K to 16 or 32 rows, C and C2 to multiples of 16)
COST_ATTENTION_SHAPES = [(512, 16, 64, 32), (8192, 16, 64, 32),
                         (2048, 16, 64, 32), (512, 5, 64, 32),
                         (512, 32, 64, 32), (512, 16, 35, 32),
                         (512, 16, 128, 32), (512, 16, 64, 17),
                         (512, 16, 64, 64), (512, 5, 35, 17),
                         (512, 32, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", COST_ATTENTION_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_cost_attention_matches_plain(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    n, kk, c, c2 = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, qc = (0.3 * torch.randn(2, n, kk, c, device="cuda",
                                  generator=gen) for _ in range(3))
    q, k, qc = q.to(dt), k.to(dt), qc.to(dt)
    wn = tuple(0.3 * torch.randn(*s, device="cuda", generator=gen)
               for s in [(c, c), (c,), (c, c2), (c2,), (c2, 1), (1,)])
    before = attention.LAUNCHES["cost_attention"]
    cf, wk = attention.cost_attention_fused(q, k, qc, wn)
    assert attention.LAUNCHES["cost_attention"] == before + 1
    pcf, pwk = attention.cost_attention_plain(q, k, qc, wn)
    assert cf.dtype == dt and wk.dtype == torch.float32
    if dtype == "float32":
        torch.testing.assert_close(cf, pcf, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(wk, pwk, rtol=1e-4, atol=1e-4)
    else:
        err, ref = (cf.float() - pcf.float()).abs(), pcf.float().abs()
        rms = ref.pow(2).mean().sqrt()
        assert (err <= 1e-6 + 2.0 ** -8 * ref).float().mean() >= 0.9999
        assert bool((err <= 2.0 ** -7 * (ref + rms)).all()), err.max().item()
        ew = (wk - pwk).abs()
        assert (ew <= 1e-3).float().mean() >= 0.9999
        assert ew.max().item() <= 4e-3
    with pytest.raises(TypeError):  # mixed feature types
        attention.cost_attention_fused(q, k, qc.double(), wn)


def _seq_mm(a, b):
    """a @ b as one float32 FMA after another over the inner index, inner
    index ascending: bf16 operands make each product exact in float32, so
    a product and a rounded add are one FMA."""
    acc = torch.zeros(*a.shape[:-1], b.shape[-1], device=a.device)
    for m in range(a.shape[-1]):
        acc = acc + a[..., m, None].float() * b[..., m:m + 1, :].float()
    return acc


def _col_sum(e):
    """Sum over the row index (dim -2) in four accumulators of i mod 4,
    each in ascending i, combined as ((a0 + a1) + a2) + a3."""
    acc = [torch.zeros_like(e[..., 0, :]) for _ in range(4)]
    for i in range(e.shape[-2]):
        acc[i % 4] = acc[i % 4] + e[..., i, :]
    return ((acc[0] + acc[1]) + acc[2]) + acc[3]


def _row_sum(e):
    """Sum over the column index (dim -1) in a halving tree over 32 columns
    (zeros past K): the upper half added onto the lower, 16, 8, 4, 2, 1."""
    x = torch.nn.functional.pad(e, (0, 32 - e.shape[-1]))
    for w in (16, 8, 4, 2, 1):
        x = x[..., :w] + x[..., w:2 * w]
    return x[..., 0]


# the main path's two launches and the 32-row, 128-channel instance's
# shape; at odd widths cuBLAS takes other orders (at C = 35, C2 = 17 the
# second layer's product is not summed one FMA after another), and there
# the kernel's agreement rests on test_cuda_cost_attention_matches_plain's
# tolerance alone
ORDER_SHAPES = [(8192, 16, 64, 32), (2048, 16, 64, 32), (512, 32, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ORDER_SHAPES)
def test_cuda_plain_sum_orders(cuda_dev, shape):
    """The summation orders of cost_attention_plain's library calls on the
    card (cuBLAS's float32 products, torch.sum over either axis of the
    [.., K, K] score tile), which the bf16 cost_attention kernel reproduces
    so that its bf16 roundings are the plain version's. A failure here
    means the library changed its order (a PyTorch or cuBLAS update), not
    that the kernel is at fault: the kernel's agreement with its plain
    version falls then, and its card test may fail with it."""
    n, kk, c, c2 = shape
    gen = torch.Generator(device="cuda").manual_seed(4)

    def bf(*s):
        return (0.3 * torch.randn(1, *s, device="cuda", generator=gen)).to(
            torch.bfloat16)

    q, k, x = bf(n, kk, c), bf(n, kk, c), bf(n, kk, c)
    w = torch.rand(1, n, kk, kk, device="cuda", generator=gen).to(
        torch.bfloat16)
    w1, w2 = bf(c, c)[0], bf(c, c2)[0]
    mm = attention._mm32
    for what, got, want in [
            ("S = q k^T", mm(q, k.transpose(-1, -2)),
             _seq_mm(q, k.transpose(-1, -2))),
            ("W k", mm(w, k), _seq_mm(w, k)),
            ("W^T q", mm(w.transpose(-1, -2), q),
             _seq_mm(w.transpose(-1, -2), q)),
            ("x W1", mm(x, w1), _seq_mm(x, w1)),
            ("h W2", mm(x, w2), _seq_mm(x, w2))]:
        assert torch.equal(got, want), (
            f"plain order changed: torch.matmul's float32 {what} at "
            f"{tuple(got.shape)} no longer sums one FMA after another")
    e = torch.rand(1, n, kk, kk, device="cuda", generator=gen)
    assert torch.equal(torch.sum(e, dim=-2), _col_sum(e)), (
        "plain order changed: torch.sum over dim -2 of [.., K, K] no longer "
        "sums in four strided accumulators")
    assert torch.equal(torch.sum(e, dim=-1), _row_sum(e)), (
        "plain order changed: torch.sum over dim -1 of [.., K, K] no longer "
        "sums in a halving tree over 32")


@pytest.mark.cuda
@pytest.mark.parametrize("cloud", SPLIT_CLOUDS)
@pytest.mark.parametrize("bsz", [1, 4])
@pytest.mark.parametrize("n", SPLIT_N)
@pytest.mark.parametrize("params", SPLIT_PARAMS)
@pytest.mark.parametrize("k", SPLIT_K)
def test_cuda_knn_matches_plain(cuda_dev, k, params, n, bsz, cloud):
    q, p, plan = _split_case(n, bsz, params, cloud)
    want = banded.knn_plain(q, p, k, plan, params)
    before = banded.LAUNCHES["knn"]
    got = banded.knn(q, p, k, plan, params)
    assert banded.LAUNCHES["knn"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if cloud == "padded" and k > 5:  # slots past the band's 5 valid rows
        assert bool((want[0] >= 5e9).any())


@pytest.mark.cuda
@pytest.mark.parametrize("feats", SPLIT_FEATS)
@pytest.mark.parametrize("cloud", SPLIT_CLOUDS)
@pytest.mark.parametrize("bsz", [1, 4])
@pytest.mark.parametrize("n", SPLIT_N)
@pytest.mark.parametrize("params", SPLIT_PARAMS)
@pytest.mark.parametrize("k", SPLIT_K)
def test_cuda_knn_group2_matches_plain(cuda_dev, k, params, n, bsz, cloud,
                                       feats):
    q, p, plan = _split_case(n, bsz, params, cloud)
    # search b: a warped copy of search a's clouds, as the cost volume makes
    # it, searched under search a's plan
    gen = torch.Generator(device="cuda").manual_seed(1)
    qb = q + 0.05 * torch.randn(q.shape, generator=gen, device="cuda")
    pb = p + 0.05 * torch.randn(p.shape, generator=gen, device="cuda")
    f = _split_feats(bsz, p.shape[1], *feats)
    want = banded.knn_group2_plain(q, qb, p, pb, f, k, plan, params)
    before = banded.LAUNCHES["knn_group2"]
    got = banded.knn_group2(q, qb, p, pb, f, k, plan, params)
    assert banded.LAUNCHES["knn_group2"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the two searches differ: search b is not search a's copy
    assert not torch.equal(got[1], got[4])


def _scatter_plan(kind, bsz, params):
    """(idx [bsz, 1024, K] int32 on the card, plan, n_out) of one plan kind,
    as tests/test_torch_scatter_blocks.py makes them: the lidar cloud's
    knn_group indices under its plan; a plan whose bands overlap unevenly,
    one that leaves band blocks no tile reaches and one that puts every
    tile on one band, with indices in band and 20 % anywhere; entries out
    of their band; n_out below the target count."""
    q, p, plan = _split_case(1024, bsz, params, "lidar")
    wblk, m = params[1], p.shape[1]
    n_bands, tiles = m // wblk, 1024 // 256
    rng = np.random.default_rng(7)
    if kind in ("lidar", "out_of_band", "n_out_below_m"):
        f = torch.zeros(bsz, m, 4, device="cuda")
        _, idx, _ = banded.knn_group(q, p, f, K, plan, params)
    else:
        b0 = {"uneven": np.array([0, 0, 3, n_bands - 3]),
              "unreached": np.zeros(tiles, np.int64),
              "all_reach": np.full(tiles, n_bands // 2 - 1)}[kind]
        b0 = torch.from_numpy(np.stack([np.roll(b0, i) for i in range(bsz)]))
        plan = (b0.to(torch.int32).cuda(), m)
        base = torch.repeat_interleave(plan[0].long() * wblk, 256, dim=1)
        near = base[..., None] + torch.from_numpy(
            rng.integers(0, 3 * wblk, (bsz, 1024, K))).cuda()
        anywhere = torch.from_numpy(rng.integers(0, m, (bsz, 1024, K))).cuda()
        wild = torch.from_numpy(rng.random((bsz, 1024, K)) < 0.2).cuda()
        idx = torch.where(wild, anywhere, near).to(torch.int32)
    if kind == "out_of_band":  # out of the first tile's band: dropped
        idx[:, :256:37, 0] = m - 1
    n_out = 3 * m // 4 - 5 if kind == "n_out_below_m" else m
    return idx.contiguous(), plan, n_out


SCATTER_KINDS = ["lidar", "uneven", "unreached", "all_reach", "out_of_band",
                 "n_out_below_m"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_scatter_add_matches_plain(case, dtype):
    c = case
    _, idx, _ = banded.knn_group(c["q"], c["p"], c["feats"], K, c["plan"],
                                 PARAMS)
    idx[:, :256:37, 0] = M - 1  # out of the first tile's band: dropped
    gen = torch.Generator(device="cuda").manual_seed(2)
    vals = torch.randn(B, N, K, C, device="cuda", generator=gen)
    vals = vals.to(getattr(torch, dtype))
    before = banded.LAUNCHES["scatter_add"]
    got = banded.scatter_add(idx, vals, c["plan"], PARAMS, M)
    assert banded.LAUNCHES["scatter_add"] == before + 1
    want = banded.scatter_add_plain(idx, vals, c["plan"], PARAMS, M)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SCATTER_KINDS)
@pytest.mark.parametrize("c", [35, 99, 260])
@pytest.mark.parametrize("bsz", [1, 4])
@pytest.mark.parametrize("params", SPLIT_PARAMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_scatter_add_plans_match_plain(cuda_dev, dtype, params, bsz, c,
                                            kind):
    idx, plan, n_out = _scatter_plan(kind, bsz, params)
    gen = torch.Generator(device="cuda").manual_seed(2)
    vals = torch.randn(bsz, 1024, K, c, device="cuda", generator=gen)
    vals = vals.to(getattr(torch, dtype))
    before = banded.LAUNCHES["scatter_add"]
    got = banded.scatter_add(idx, vals, plan, params, n_out)
    assert banded.LAUNCHES["scatter_add"] == before + 1
    want = banded.scatter_add_plain(idx, vals, plan, params, n_out)
    # index_add_'s float32 atomics and the kernel's sum in two orders that
    # change from run to run: within 1e-6 + 1e-5 |want| beyond the rounding
    # bound of the two sums
    slack = banded.scatter_add_slack(idx, vals, plan, params, n_out)
    err = (got.double() - want.double()).abs()
    assert bool((err <= 1e-6 + 1e-5 * want.abs().double() + slack).all()), \
        f"max error {err.max().item():.3g}"


def _misaligned(t):
    """A contiguous copy of t that starts one element past its
    allocation's start, so that no vector load of its rows is aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("kind", SCATTER_KINDS)
@pytest.mark.parametrize("c", [35, 64, 131])
@pytest.mark.parametrize("bsz", [1, 4])
@pytest.mark.parametrize("params", SPLIT_PARAMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_regroup_plans_match_plain(cuda_dev, dtype, params, bsz, c,
                                        kind, offset):
    """regroup equals regroup_plain bit for bit: 16-byte units where C and
    the pointers allow, narrower units for odd row widths (C = 35, 131) and
    for feats one element off its allocation's alignment (offset 1)."""
    idx, plan, _ = _scatter_plan(kind, bsz, params)
    m = 2048 if params[1] == 256 else 512
    idx = idx % m  # rows of feats (the uneven plan's bands reach past m)
    feats = torch.from_numpy(np.random.default_rng(c).normal(
        size=(bsz, m, c)).astype(np.float32)).cuda().to(getattr(torch, dtype))
    if offset:
        feats = _misaligned(feats)
    before = banded.LAUNCHES["regroup"]
    got = banded.regroup(idx, feats, plan, params)
    assert banded.LAUNCHES["regroup"] == before + 1
    want = banded.regroup_plain(idx, feats, plan, params)
    assert got.dtype == feats.dtype and torch.equal(got, want)
    if kind == "out_of_band":
        assert bool((got[:, :256:37, 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("kind", SCATTER_KINDS)
@pytest.mark.parametrize("c", [35, 64, 131])
@pytest.mark.parametrize("bsz", [1, 4])
@pytest.mark.parametrize("params", SPLIT_PARAMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_scatter_softmax_sum_plans_match_plain(cuda_dev, dtype, params,
                                                    bsz, c, kind, offset):
    """scatter_softmax_sum (scatter_add's tile-band body with the e column)
    against its plain version over scatter_add's plans, with vector loads
    (C = 64) and without (C = 35, 131, or values one element off their
    allocation's alignment): within 1e-6 + 1e-5 |want| beyond the rounding
    bound of two float32 sums in two orders, as scatter_add."""
    idx, plan, n_out = _scatter_plan(kind, bsz, params)
    gen = torch.Generator(device="cuda").manual_seed(2)
    vals = torch.randn(bsz, 1024, K, c, device="cuda", generator=gen)
    vals = vals.to(getattr(torch, dtype))
    if offset:
        vals = _misaligned(vals)
    w = torch.randn(bsz, 1024, K, device="cuda", generator=gen)
    w = (w - w.max()).contiguous()
    before = banded.LAUNCHES["scatter_softmax_sum"]
    got = banded.scatter_softmax_sum(idx, vals, w, plan, params, n_out)
    assert banded.LAUNCHES["scatter_softmax_sum"] == before + 1
    want = banded.scatter_softmax_sum_plain(idx, vals, w, plan, params,
                                            n_out)
    slack = banded.scatter_softmax_sum_slack(idx, vals, w, plan, params,
                                             n_out)
    err = (got.double() - want.double()).abs()
    assert bool((err <= 1e-6 + 1e-5 * want.abs().double() + slack).all()), \
        f"max error {err.max().item():.3g}"


@pytest.mark.cuda
def test_cuda_grouping_backward_through_scatter_add(case):
    """nn_knn_group's backward on the card sums segments with the
    scatter_add kernel; the plain version on the same graph agrees."""
    c = case
    f = c["feats"].clone().requires_grad_()
    _, grouped, _, _ = nb.nn_knn_group(c["q"], c["p"], f, K, "banded",
                                       box=nb.cloud_box(c["q"], c["p"]))
    gen = torch.Generator(device="cuda").manual_seed(3)
    r = torch.randn(grouped.shape, device="cuda", generator=gen)
    before = banded.LAUNCHES["scatter_add"]
    (got,) = torch.autograd.grad(grouped, f, r, retain_graph=True)
    assert banded.LAUNCHES["scatter_add"] == before + 1
    kernel = banded.scatter_add
    banded.scatter_add = banded.scatter_add_plain
    try:
        (want,) = torch.autograd.grad(grouped, f, r)
    finally:
        banded.scatter_add = kernel
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# attention's shapes: the main path's K = 16 and C = 64, padded rows (K =
# 9, 20) and channels (C = 99), both row-tile counts of the tensor-core
# body (K = 32) and its channel instances (C = 32, 128), and the CUDA-core
# body's channels past them (C = 200); N = 517 points (not a multiple of
# either body's warps a block) alone or in a batch of 2
ATTENTION_K = [16, 9, 32, 20]
ATTENTION_C = [64, 32, 128, 99, 200]
ATTENTION_LEAD = [(517,), (2, 517)]


@pytest.mark.cuda
@pytest.mark.parametrize("lead", ATTENTION_LEAD)
@pytest.mark.parametrize("c", ATTENTION_C)
@pytest.mark.parametrize("k", ATTENTION_K)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_matches_plain(cuda_dev, dtype, k, c, lead):
    """attention_fused against attention_plain on [*lead, K, C]: float32
    within 1e-5, bf16 within one bf16 step (2^-7 of the value) on 99.99 %
    and two steps of (|value| + rms) everywhere, as chip_smoke.py's
    ATTENTION_TOL; bf16 with C <= 128 runs the tensor-core body ("mma"),
    the rest the CUDA-core body ("simt")."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    dt = getattr(torch, dtype)
    q, kf = (0.3 * torch.randn(*lead, k, c, device="cuda", generator=gen)
             .to(dt) for _ in range(2))
    want_body = "mma" if dtype == "bfloat16" and c <= 128 else "simt"
    assert attention.attention_body(dt, k, c) == want_body
    before = attention.LAUNCHES["attention"]
    got = attention.attention_fused(q, kf)
    assert attention.LAUNCHES["attention"] == before + 1
    want = attention.attention_plain(q, kf)
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        if dtype == "float32":
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        else:
            err, ref = (g.float() - w.float()).abs(), w.float().abs()
            rms = ref.pow(2).mean().sqrt()
            assert (err <= 1e-6 + 2.0 ** -7 * ref).float().mean() >= 0.9999
            assert bool((err <= 2 * 2.0 ** -7 * (ref + rms)).all())
    qg, kg = (t.float().requires_grad_() for t in (q, kf))
    qa, ka = attention.attention_fused(qg, kg)
    (qa.sum() + 2.0 * ka.sum()).backward()
    q2, k2 = (t.float().requires_grad_() for t in (q, kf))
    qa2, ka2 = attention.attention_xla(q2, k2)
    (qa2.sum() + 2.0 * ka2.sum()).backward()
    torch.testing.assert_close(qg.grad, q2.grad)
    torch.testing.assert_close(kg.grad, k2.grad)


# ---------------------------------------------------------------------------
# the other pipeline variants' modules (no kernels of their own): the port
# on the card against the port on the CPU, on the same inputs
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _street_frames():
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    return generate_sequence(n_frames=5, n_points=8192, seed=100,
                             noise=0.004, n_moving=4)


def _street_features(dev):
    from ssf_slam_tpu_torch import config as tc
    from ssf_slam_tpu_torch.frontend.features import (
        FeatureCloud,
        extract_plane_features,
    )

    feats = [extract_plane_features(
        torch.from_numpy(f["pos1"].astype(np.float32)),
        torch.from_numpy(f["mask1"].astype(bool)), tc.LidarConfig(),
        tc.FeatureConfig()) for f in _street_frames()]
    return [FeatureCloud(*(t.to(dev) for t in c)) for c in feats]


def _both(fn, *args, **kw):
    """fn on the CPU and on the card, on the same inputs (tensors, tuples
    of tensors); outputs as numpy."""
    def move(a, dev):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return type(a)(*(move(x, dev) for x in a))
        return a

    def run(dev):
        out = fn(*(move(a, dev) for a in args),
                 **{k: move(v, dev) for k, v in kw.items()})
        if isinstance(out, torch.Tensor):
            out = (out,)
        return [o.cpu().numpy() for o in out]

    return run(torch.device("cpu")), run(torch.device("cuda"))


@pytest.mark.cuda
def test_cuda_gmm_em_matches_cpu(cuda_dev):
    """gmm_em on [flow || xyz] of an 8192-point scan: labels equal, means
    within 1e-4 relative + 1e-4 (float32 sums of 8192 terms in other
    orders; the xyz means reach 35 m), weights within 1e-5."""
    from ssf_slam_tpu_torch.ops.gmm import gmm_em

    f = _street_frames()[2]
    x = torch.from_numpy(np.concatenate([f["gt"], f["pos1"]], -1)
                         .astype(np.float32))
    valid = torch.from_numpy(f["mask1"].astype(bool))
    (cl, _, cm, cw), (gl, _, gm, gw) = _both(gmm_em, x, valid)
    assert 0 < cl[f["mask1"].astype(bool)].sum() < valid.sum()
    np.testing.assert_array_equal(gl, cl)
    np.testing.assert_allclose(gm, cm, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gw, cw, atol=1e-5)


@pytest.mark.cuda
def test_cuda_fit_ring_diverse_planes_matches_cpu(cuda_dev):
    """valid equal, the valid planes' normals within 1e-5."""
    from ssf_slam_tpu_torch.odometry.scan2scan import fit_ring_diverse_planes

    cloud = _street_features(torch.device("cpu"))[2]
    (cn, cv), (gn, gv) = _both(fit_ring_diverse_planes, cloud)
    np.testing.assert_array_equal(gv, cv)
    assert cv.sum() > 100
    np.testing.assert_allclose(gn[cv], cn[cv], atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("pred", [None, (1.2, 0.0, 0.0), (0.6, 0.3, 0.0)])
def test_cuda_bev_pose_init_matches_cpu(cuda_dev, pred):
    """The yaw equal and t within 1e-4 m (cuFFT and pocketfft round the
    correlation differently; this scene's best two yaws are 397 and 316
    apart, far from a tie)."""
    from ssf_slam_tpu_torch.odometry.bev_init import bev_pose_init

    last, curr = _street_frames()[2], _street_frames()[3]
    c, s = np.cos(0.05), np.sin(0.05)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    args = [torch.from_numpy(a) for a in (
        (curr["pos1"] @ rot.T).astype(np.float32),
        curr["mask1"].astype(bool), last["pos1"].astype(np.float32),
        last["mask1"].astype(bool))]
    kw = {} if pred is None else dict(
        pred_t=torch.tensor(pred, dtype=torch.float32), plaus_gate=0.4,
        plaus_rel=0.5)
    (cy, ct), (gy, gt) = _both(bev_pose_init, *args, **kw)
    assert float(gy) == float(cy)
    np.testing.assert_allclose(gt, ct, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("pick", ["bev", "score"])
def test_cuda_scan_to_scan_matches_cpu(cuda_dev, pick):
    """q within 1e-5, t within 1e-4 m, n_inliers equal."""
    from ssf_slam_tpu_torch import config as tc
    from ssf_slam_tpu_torch.odometry.scan2scan import (
        fit_ring_diverse_planes,
        scan_to_scan,
    )

    feats = _street_features(torch.device("cpu"))
    curr, last = feats[3], feats[2]
    q0 = torch.tensor([0.0, 0.0, 0.005, 1.0])
    q0 = q0 / q0.norm()
    t0 = torch.tensor([0.9, 0.05, 0.0])
    (cq, ct, cn), (gq, gt, gn) = _both(
        scan_to_scan, curr, last, fit_ring_diverse_planes(last), q0, t0,
        tc.OdometryConfig(hypothesis_pick=pick),
        curr_planes=fit_ring_diverse_planes(curr))
    assert int(cn) > 100 and int(gn) == int(cn)
    np.testing.assert_allclose(gq, cq, atol=1e-5)
    np.testing.assert_allclose(gt, ct, atol=1e-4)


@pytest.mark.cuda
def test_cuda_refine_flow_pose_matches_cpu(cuda_dev):
    """q within 1e-5, t within 1e-4 m; the refine moves the pose."""
    from ssf_slam_tpu_torch.odometry.egomotion import ego_motion_from_flow
    from ssf_slam_tpu_torch.odometry.flow_refine import refine_flow_pose
    from ssf_slam_tpu_torch.odometry.scan2scan import fit_ring_diverse_planes

    prev = _street_frames()[2]
    feat = _street_features(torch.device("cpu"))[3]
    pts = torch.from_numpy(prev["pos1"].astype(np.float32))
    static = torch.from_numpy((prev["s_fg_mask"] < 0.5)
                              & prev["mask1"].astype(bool))
    q0, t0 = ego_motion_from_flow(
        pts, torch.from_numpy((prev["gt"] * 1.03).astype(np.float32)), static)
    (cq, ct), (gq, gt) = _both(refine_flow_pose, pts, static, feat,
                               fit_ring_diverse_planes(feat), q0, t0)
    assert np.abs(ct - t0.numpy()).max() > 1e-3
    np.testing.assert_allclose(gq, cq, atol=1e-5)
    np.testing.assert_allclose(gt, ct, atol=1e-4)


# the host syncs the step had before these variants: the keyframe gate,
# loop detection and acceptance (mapping/keyframes.py) and the Kabsch's
# SVD (ops/kabsch.py); every other sync fails the test below
ALLOWED_SYNCS = {("keyframes.py", "_is_keyframe"),
                 ("keyframes.py", "_detect_loop"),
                 ("keyframes.py", "_try_close_loop"),
                 ("kabsch.py", "kabsch")}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["ONLY_PC", "SF"])
def test_cuda_variant_step_adds_no_host_sync(cuda_dev, variant):
    """slam_step of ONLY_PC and of SF with geom_refine (the GMM, the BEV
    init, both GN solves, the plane fits and the local map) on 8192-point
    scans under torch.cuda.set_sync_debug_mode after the first frame: each
    sync is traced to the innermost port function that reached it, and
    only ALLOWED_SYNCS may appear. (PyTorch's own notice that the mode
    "does not yet detect all synchronizing operations" is not a sync.)"""
    import os
    import traceback
    import warnings

    import ssf_slam_tpu_torch
    from ssf_slam_tpu_torch import config as tc
    from ssf_slam_tpu_torch.engine import pipeline

    cfg = tc.PipelineConfig(variant=tc.Variant[variant],
                            egomotion=tc.EgoMotionConfig(geom_refine=True))
    frames = list(_street_frames())
    for f in frames:
        f["flow"] = (f["gt"] * 1.03).astype(np.float32)
    scans = {k: torch.as_tensor(v, device=cuda_dev) for k, v in
             pipeline.stack_scans(frames, cfg, "flow").items()}
    state = pipeline.init_slam_state(cfg, cuda_dev)
    pkg = os.path.dirname(ssf_slam_tpu_torch.__file__)
    sites = []

    def note(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            f = [f for f in traceback.extract_stack()
                 if f.filename.startswith(pkg)][-1]
            sites.append((os.path.basename(f.filename), f.name, f.lineno))

    with torch.inference_mode():
        for k in range(len(frames)):
            scan = {key: v[k] for key, v in scans.items()}
            if k == 0:
                state, _ = pipeline.slam_step(state, scan, cfg)
                torch.cuda.synchronize()
                continue
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = note
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    state, out = pipeline.slam_step(state, scan, cfg)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            assert bool(torch.isfinite(out["pose_t"]).all())
    print(f"{variant}: {len(sites)} syncs in {len(frames) - 1} scans: "
          f"{sorted(set(sites))}")
    assert sites, "no sync seen: the keyframe gate syncs on every frame"
    extra = [s for s in sites if s[:2] not in ALLOWED_SYNCS]
    assert not extra, f"host syncs outside the allowed sites: {extra}"


# the ssfc classifier's banded launches per call at 8192 points: sa1
# (1024 <- 8192) and fp1 (8192 <- 1024) take knn_group; sa2 and fp2 (1024 x
# 256) fall under the work floor and take the exact path
SEGNET_LAUNCHES = {"knn_group": 2}


@pytest.mark.cuda
def test_cuda_segnet_matches_cpu(cuda_dev):
    """SegNet at 8192 points with the committed weights on a street pair
    ([xyz || ground-truth flow]): its kNN launches (two knn_group, nothing
    else), float32 logits within 1e-4 of the CPU's and the static masks
    equal; bf16 logits finite, with static masks equal to float32's on at
    least 99.5 % of the points (bf16 moves logits near 0 across it)."""
    from ssf_slam_tpu_torch.weights import load_segnet

    f = _street_frames()[2]
    xyz = torch.from_numpy(f["pos1"].astype(np.float32))[None]
    flow = torch.from_numpy(f["gt"].astype(np.float32))[None]
    out = {}
    for dev in (torch.device("cpu"), cuda_dev):
        for dtype in ("float32", "bfloat16"):
            seg = load_segnet(dtype=dtype, device=dev)
            banded.reset_launches()
            with torch.inference_mode():
                logits = seg(xyz.to(dev), flow.to(dev))[0].float().cpu()
            launches = {k: v for k, v in banded.LAUNCHES.items() if v}
            assert launches == (SEGNET_LAUNCHES if dev.type == "cuda"
                                else {}), launches
            assert bool(torch.isfinite(logits).all())
            out[dev.type, dtype] = logits
    torch.testing.assert_close(out["cuda", "float32"], out["cpu", "float32"],
                               rtol=0, atol=1e-4)
    static = {k: v.argmax(-1) == 0 for k, v in out.items()}
    assert torch.equal(static["cuda", "float32"], static["cpu", "float32"])
    assert 0 < int((~static["cuda", "float32"]).sum())
    agree = (static["cuda", "bfloat16"]
             == static["cuda", "float32"]).float().mean()
    assert float(agree) >= 0.995, float(agree)


# the small TFlow (banded at level 0: 1024 x 1024 meets the work floor) and
# the small SLAM step without loop closure and scan-to-map refine, as
# tests/test_torch_parallel.py runs them on the CPU
SMALL_NET = dict(npoint=1024, sa_npoints=(512, 256, 128, 64),
                 joint_seg=True, neighbor_backend="banded")
BATCHED_TOL = 1e-3  # m: the scatters' float32 atomics differ run to run


@pytest.mark.cuda
def test_cuda_fused_batched_matches_members_alone(cuda_dev):
    """run_sequences_fused_batched at B = 2 (4 frames x 1024 points, f32,
    the committed weights) against each member run alone through
    run_sequence_fused under the shared box: pose_t and odom_t within
    1e-3 m, is_keyframe equal, and the batched run's kernel launches equal
    to one member's alone (the network runs once a scan over the batch)."""
    from ssf_slam_tpu_torch import config as tc
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.engine.fused import (
        run_sequence_fused,
        sequence_box,
        stack_fused_scans,
    )
    from ssf_slam_tpu_torch.parallel.mesh import run_sequences_fused_batched
    from ssf_slam_tpu_torch.weights import load_tflow

    seqs = [generate_sequence(n_frames=4, n_points=1024, seed=100 + b,
                              noise=0.004, n_moving=4) for b in range(2)]
    cfg = tc.PipelineConfig(
        variant=tc.Variant.SSF, lidar=tc.LidarConfig(max_points=1024),
        features=tc.FeatureConfig(max_features=512, plane_curv_max_16=1.0,
                                  plane_stride_16=1),
        mapping=tc.MappingConfig(
            max_keyframes=16, submap_points=1024, icp_iters=4,
            loop_submap_halfwidth=2, refine_submap_points=512,
            refine_stride=1, refine_min_inliers=16, keyframe_trans_gate=2.0,
            enable_loop_closure=False, scan_to_map_refine=False))
    model = load_tflow(tc.FlowNetConfig(**SMALL_NET), device=cuda_dev)
    box = sequence_box(np.stack([stack_fused_scans(s, 1024)["points"]
                                 for s in seqs]), device=cuda_dev)
    banded.reset_launches()
    _, got = run_sequences_fused_batched(model, seqs, cfg, device=cuda_dev,
                                         box=box)
    batched = dict(banded.LAUNCHES)
    assert batched["knn_group"] > 0
    for b, seq in enumerate(seqs):
        banded.reset_launches()
        alone = run_sequence_fused(model, seq, cfg, device=cuda_dev, box=box)
        assert dict(banded.LAUNCHES) == batched
        for key in ("pose_t", "odom_t"):
            np.testing.assert_allclose(got[key][b], alone[key],
                                       atol=BATCHED_TOL, err_msg=key)
        np.testing.assert_array_equal(got["is_keyframe"][b],
                                      alone["is_keyframe"])
        assert np.isfinite(got["flow"][b]).all()
