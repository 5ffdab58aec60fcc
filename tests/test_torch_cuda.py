"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; where CUDA is absent they skip.
The file imports no JAX (the card's machine has none), so it runs there
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Inputs: Morton-sorted lidar-like clouds (B=2, N=1024, M=2048, C=16) from a
numpy seed. Tolerances: sqdist, idx, grouped and regroup EXACT; knn_idw
(float32) 1e-5 relative + 1e-6 absolute (the same float32 operations, so
in practice equal); scatter_softmax_sum 1e-5 relative + 1e-6 absolute, for
the float32 atomics' run-to-run order. cost_attention ([2, 512, 16, 64]
patches from a seed): float32 within 1e-4 (sum orders); bf16 cost_fwd
within one bf16 step of its value on 99.99 % of the elements and within two
steps of (|value| + rms) everywhere, w_k within 1e-3 on 99.99 % and 4e-3
everywhere (chip_smoke.py's COST_ATTENTION_TOL explains the rounding flips
behind these, and leaves more room for its network-made inputs, which vary
from run to run).
"""

from __future__ import annotations

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_knn_group_matches_plain(case, dtype):
    c = case
    f = c["feats"].to(getattr(torch, dtype))
    before = banded.LAUNCHES["knn_group"]
    got = banded.knn_group(c["q"], c["p"], f, 16, c["plan"], PARAMS)
    assert banded.LAUNCHES["knn_group"] == before + 1
    want = banded.knn_group_plain(c["q"], c["p"], f, 16, c["plan"], PARAMS)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 7])
def test_cuda_knn_idw_matches_plain(case, k):
    c = case
    got = banded.knn_idw(c["q"], c["p"], c["feats"], k, c["plan"], PARAMS)
    want = banded.knn_idw_plain(c["q"], c["p"], c["feats"], k, c["plan"],
                                PARAMS)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)


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
