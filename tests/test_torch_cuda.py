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
Tolerances: sqdist, idx, grouped (knn_group and knn_group2's
twin searches), knn's and regroup EXACT; knn_idw's output float32 1e-5
relative + 1e-6 absolute (the same float32 operations, so in practice
equal), bf16 within one bf16 rounding step (2^-8 relative + 1e-6), as
chip_smoke.py holds it; scatter_softmax_sum and scatter_add 1e-5 relative +
1e-6 absolute, for the float32 atomics' run-to-run order (so is the
grouping backward through scatter_add against its plain version);
attention ([2, 512, 16, 64]): float32 within 1e-5, bf16 within one bf16
step on 99.99 % and two steps of (|value| + rms) everywhere, and its
gradient equal to attention_xla's. cost_attention ([2, 512, 16, 64]
patches from a seed): float32 within 1e-4 (sum orders); bf16 cost_fwd
within one bf16 step of its value on 99.99 % of the elements and within two
steps of (|value| + rms) everywhere, w_k within 1e-3 on 99.99 % and 4e-3
everywhere (chip_smoke.py's COST_ATTENTION_TOL explains the rounding flips
behind these, and leaves more room for its network-made inputs, which vary
from run to run).
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_cost_attention_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, qc = (0.3 * torch.randn(2, 512, 16, 64, device="cuda",
                                  generator=gen) for _ in range(3))
    q, k, qc = q.to(dt), k.to(dt), qc.to(dt)
    wn = tuple(0.3 * torch.randn(*s, device="cuda", generator=gen)
               for s in [(64, 64), (64,), (64, 32), (32,), (32, 1), (1,)])
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


@pytest.mark.cuda
def test_cuda_knn_and_knn_group2_match_plain(case):
    c = case
    before = dict(banded.LAUNCHES)
    got = banded.knn(c["q"], c["p"], 16, c["plan"], PARAMS)
    want = banded.knn_plain(c["q"], c["p"], 16, c["plan"], PARAMS)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    gen = torch.Generator(device="cuda").manual_seed(1)
    qb = c["q"] + 0.05 * torch.randn(c["q"].shape, generator=gen,
                                     device="cuda")
    pb = c["p"] + 0.05 * torch.randn(c["p"].shape, generator=gen,
                                     device="cuda")
    for f in (c["feats"], c["feats"].to(torch.bfloat16)):
        got = banded.knn_group2(c["q"], qb, c["p"], pb, f, K, c["plan"],
                                PARAMS)
        want = banded.knn_group2_plain(c["q"], qb, c["p"], pb, f, K,
                                       c["plan"], PARAMS)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert banded.LAUNCHES["knn"] == before["knn"] + 1
    assert banded.LAUNCHES["knn_group2"] == before["knn_group2"] + 2


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_matches_plain(dtype):
    """attention_fused against attention_plain on [2, 512, 16, 64]; bf16
    within one bf16 step (2^-7 of the value) on 99.99 % and two steps of
    (|value| + rms) everywhere, as chip_smoke.py's ATTENTION_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    gen = torch.Generator(device="cuda").manual_seed(4)
    dt = getattr(torch, dtype)
    q, k = (0.3 * torch.randn(2, 512, 16, 64, device="cuda", generator=gen)
            for _ in range(2))
    q, k = q.to(dt), k.to(dt)
    before = attention.LAUNCHES["attention"]
    got = attention.attention_fused(q, k)
    assert attention.LAUNCHES["attention"] == before + 1
    want = attention.attention_plain(q, k)
    for g, w in zip(got, want):
        assert g.dtype == dt
        if dtype == "float32":
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        else:
            err, ref = (g.float() - w.float()).abs(), w.float().abs()
            rms = ref.pow(2).mean().sqrt()
            assert (err <= 1e-6 + 2.0 ** -7 * ref).float().mean() >= 0.9999
            assert bool((err <= 2 * 2.0 ** -7 * (ref + rms)).all())
    qg, kg = (t.float().requires_grad_() for t in (q, k))
    qa, ka = attention.attention_fused(qg, kg)
    (qa.sum() + 2.0 * ka.sum()).backward()
    q2, k2 = (t.float().requires_grad_() for t in (q, k))
    qa2, ka2 = attention.attention_xla(q2, k2)
    (qa2.sum() + 2.0 * ka2.sum()).backward()
    torch.testing.assert_close(qg.grad, q2.grad)
    torch.testing.assert_close(kg.grad, k2.grad)
