"""The port's fused cost-attention chain against the JAX package, on the CPU.

The same numpy inputs (from a seed) go through the JAX function (Pallas in
interpret mode where it is a kernel) and its counterpart in
``ssf_slam_tpu_torch``. Tolerances:
- ``fold_weightnet``: 1e-6 relative (the same float32 expression);
- ``cost_attention_xla``: 2e-5 (float32, sum orders);
- ``cost_attention_plain`` against the JAX ``cost_attention_fused``
  (interpret) in float32: 2e-4, as the JAX package's own kernel test; in
  bf16: ``cost_fwd`` within one bf16 step of the output (2^-8 relative +
  2^-8 absolute) on all but 0.5 % of the elements and within 4 steps
  everywhere, ``w_k`` within 2e-2 absolute (the bf16 roundings of the dual
  softmax product, the attended features and two hidden layers meet float32
  sums taken in other orders, so a value near a rounding midpoint can round
  the other way and move the logit by a few bf16 steps of the hidden
  units);
- ``AttentiveCostVolume`` with ``fuse_attention`` on converted weights:
  its four outputs within 1e-4;
- the small TFlow with ``fuse_attention=True``: per-level flows and the seg
  logit within 1e-3 (as the unfused model test), finest-flow mean
  end-point difference within 1e-4 m, against the JAX flows committed in
  ``tflow_small_ref.npz`` (tests/test_torch_model.py makes it).

The tensor-core body of ``csrc/attention.cu`` runs only on the card; its
arithmetic is emulated here (``_three_planes``): the patch padded with zeros
to the kernel's KP rows and CP channels, padded rows and columns masked out
of both softmaxes, W in float32 split into three bf16 planes (exactly W
wherever |W| >= 2^-110), the plane products in float32, the smallest plane
first, one rounding to bf16; held to ``attention_plain`` within
chip_smoke.py's ATTENTION_TOL: one bf16 step (2^-7 of the value, + 1e-6)
on 99.99 % of the elements, two steps of (|value| + rms) everywhere.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _chain_inputs(seed, n=256, k=16, c=64, scale=1.0):
    rng = np.random.default_rng(seed)
    q, kf, qc = (rng.normal(size=(2, n, k, c), scale=scale).astype(
        np.float32) for _ in range(3))
    wn = tuple(rng.normal(size=s, scale=0.3).astype(np.float32)
               for s in [(c, c), (c,), (c, c // 2), (c // 2,), (c // 2, 1),
                         (1,)])
    return q, kf, qc, wn


def test_fold_weightnet():
    from ssf_slam_tpu.ops.attention import fold_weightnet as j_fold
    from ssf_slam_tpu_torch.ops.attention import fold_weightnet as t_fold

    rng = np.random.default_rng(3)

    def arr(*s, pos=False):
        a = rng.normal(size=s).astype(np.float32)
        return np.abs(a) + 0.1 if pos else a

    c = 64
    params = {"Dense_0": {"kernel": arr(c, c)},
              "BatchNorm_0": {"scale": arr(c), "bias": arr(c)},
              "Dense_1": {"kernel": arr(c, c // 2)},
              "BatchNorm_1": {"scale": arr(c // 2), "bias": arr(c // 2)},
              "Dense_2": {"kernel": arr(c // 2, 1), "bias": arr(1)}}
    stats = {"BatchNorm_0": {"mean": arr(c), "var": arr(c, pos=True)},
             "BatchNorm_1": {"mean": arr(c // 2),
                             "var": arr(c // 2, pos=True)}}
    conv = jax.tree.map
    j = j_fold(conv(jnp.asarray, params), conv(jnp.asarray, stats))
    t = t_fold(conv(_t, params), conv(_t, stats))
    assert [tuple(x.shape) for x in t] == [x.shape for x in j]
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_cost_attention_xla():
    from ssf_slam_tpu.ops.attention import cost_attention_xla as j_xla
    from ssf_slam_tpu_torch.ops.attention import cost_attention_xla as t_xla

    q, k, qc, wn = _chain_inputs(4)
    jcf, jwk = j_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(qc),
                     tuple(map(jnp.asarray, wn)))
    from ssf_slam_tpu_torch.ops.attention import folded_weightnet

    tcf, twk = t_xla(_t(q), _t(k), _t(qc), folded_weightnet(
        tuple(map(_t, wn))))
    np.testing.assert_allclose(tcf.numpy(), np.asarray(jcf), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(twk.numpy(), np.asarray(jwk), atol=2e-5,
                               rtol=2e-5)


def _jax_fused(q, k, qc, wn, dtype):
    from ssf_slam_tpu.ops.attention import cost_attention_fused

    with pltpu.force_tpu_interpret_mode():
        cf, wk = cost_attention_fused(
            *(jnp.asarray(x, dtype) for x in (q, k, qc)),
            tuple(map(jnp.asarray, wn)))
    return np.asarray(cf.astype(jnp.float32)), np.asarray(wk)


@pytest.mark.parametrize("k,c", [(16, 64), (8, 32)])
def test_cost_attention_plain_f32_matches_pallas(k, c):
    from ssf_slam_tpu_torch.ops import attention

    q, kf, qc, wn = _chain_inputs(5 + k, k=k, c=c)
    jcf, jwk = _jax_fused(q, kf, qc, wn, jnp.float32)
    attention.reset_launches()
    tcf, twk = attention.cost_attention_fused(_t(q), _t(kf), _t(qc),
                                              tuple(map(_t, wn)))
    assert attention.LAUNCHES["cost_attention"] == 0  # the plain version
    assert tcf.dtype == torch.float32 and twk.dtype == torch.float32
    np.testing.assert_allclose(tcf.numpy(), jcf, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(twk.numpy(), jwk, rtol=2e-4, atol=2e-4)


def test_cost_attention_plain_bf16_matches_pallas():
    from ssf_slam_tpu_torch.ops.attention import cost_attention_plain

    q, kf, qc, wn = _chain_inputs(6, scale=0.5)
    jcf, jwk = _jax_fused(q, kf, qc, wn, jnp.bfloat16)
    bf = [_t(x).to(torch.bfloat16) for x in (q, kf, qc)]
    tcf, twk = cost_attention_plain(*bf, tuple(map(_t, wn)))
    assert tcf.dtype == torch.bfloat16 and twk.dtype == torch.float32
    err = np.abs(tcf.float().numpy() - jcf)
    step = 2.0 ** -8 * (np.abs(jcf) + 1.0)
    assert (err <= step).mean() > 0.995, (err / step).max()
    assert (err <= 4 * step).all(), (err / step).max()
    np.testing.assert_allclose(twk.numpy(), jwk, atol=2e-2)


def _flax_costvolume(fuse: bool):
    from ssf_slam_tpu.models.costvolume import AttentiveCostVolume

    return AttentiveCostVolume(nsample=16, mlp=(32, 32, 32),
                               flow_mlp=(32, 32), use_flow=True,
                               backend="banded", fuse_attention=fuse)


def test_costvolume_fused_matches_jax():
    from ssf_slam_tpu_torch.models.costvolume import AttentiveCostVolume
    from ssf_slam_tpu_torch.ops import attention
    from ssf_slam_tpu_torch.weights import from_flax

    rng = np.random.default_rng(23)
    n, d = 1024, 16
    r = rng.uniform(3, 28, n)
    th = rng.uniform(0, 2 * np.pi, n)
    xyz1 = np.stack([r * np.cos(th), r * np.sin(th),
                     rng.normal(0, 1.5, n)], -1).astype(np.float32)[None]
    xyz2 = xyz1 + rng.normal(size=(1, n, 3), scale=0.05).astype(np.float32)
    f1, f2 = (rng.normal(size=(1, n, d)).astype(np.float32)
              for _ in range(2))
    sf = rng.normal(size=(1, n, 3), scale=0.05).astype(np.float32)
    sf_feat = rng.normal(size=(1, n, 8)).astype(np.float32)
    args = (xyz1, xyz2, None, f1, f2, sf, sf_feat)

    def jargs():
        return [None if a is None else jnp.asarray(a) for a in args]

    m = _flax_costvolume(True)
    with pltpu.force_tpu_interpret_mode():
        v = m.init(jax.random.PRNGKey(0), *jargs())
        # non-trivial BatchNorm statistics in the weightnet
        stats = jax.tree.map(lambda a: np.asarray(a) + np.asarray(
            rng.uniform(0.1, 0.5, a.shape), np.float32), v["batch_stats"])
        v = {"params": v["params"], "batch_stats": stats}
        want = m.apply(v, *jargs())

    tm = AttentiveCostVolume(16, d, d, 8, (32, 32, 32), (32, 32),
                             backend="banded", fuse_attention=True)
    tm.fold_weights()
    tm.load_state_dict(from_flax(torch_ref.flatten(v)), strict=True)
    assert tm.folded() is None  # new weights drop the stale fold
    tm.eval()
    with pytest.raises(RuntimeError, match="folded weightnet"):
        with torch.inference_mode():
            tm(*[None if a is None else _t(a) for a in args])
    tm.fold_weights()
    attention.reset_launches()
    with torch.inference_mode():
        got = tm(*[None if a is None else _t(a) for a in args])
    for a, b, name in zip(got, want, ("cost_fwd", "cost_bwd", "flow_feats",
                                      "re_sf")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_small_tflow_fused_attention_matches_jax():
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.weights import load_tflow

    import test_torch_model

    with np.load(test_torch_model.TFLOW_REF) as z:
        jflows = [z[f"fused_flow{i}"] for i in range(4)]
    net = dict(torch_ref.SMALL_NET, fuse_attention=True)
    model = load_tflow(FlowNetConfig(**net), device="cpu")
    with torch.inference_mode():
        flows, _ = model(*map(torch.from_numpy, test_torch_model.small_pair()))
    for got, want in zip(flows, jflows):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    epd = np.linalg.norm(flows[0][0, :, :3].numpy() - jflows[0][0, :, :3],
                         axis=-1).mean()
    assert epd < 1e-4, epd


# where the three planes must add up to W exactly: the third plane's last
# bit lies 2^-23 below W's leading one, so it is a bf16 number (bf16's
# subnormal step is 2^-133) wherever |W| >= 2^-110
PLANES_EXACT_FROM = 2.0 ** -110


def _three_planes(q, k):
    """The tensor-core body's arithmetic in plain PyTorch for bf16 [.., K,
    C] q and k: returns (q', k', W float32, planes [3, .., K, K])."""
    *lead, kn, c = q.shape
    kp, cp = (16 if kn <= 16 else 32), next(x for x in (32, 64, 128)
                                            if c <= x)
    pad = [0, cp - c, 0, kp - kn]
    q32 = torch.nn.functional.pad(q.float(), pad)
    k32 = torch.nn.functional.pad(k.float(), pad)
    s = q32 @ k32.transpose(-1, -2)
    valid = torch.zeros(kp, kp, dtype=torch.bool)
    valid[:kn, :kn] = True
    s = s.masked_fill(~valid, -torch.inf)
    # (a padded row's or column's maximum is -inf: its exps are masked)
    e1 = torch.where(valid, torch.exp(s - torch.amax(s, -2, keepdim=True)),
                     0.0)
    e2 = torch.where(valid, torch.exp(s - torch.amax(s, -1, keepdim=True)),
                     0.0)
    s1 = e1 / torch.sum(e1, dim=-2, keepdim=True)
    s2 = e2 / torch.sum(e2, dim=-1, keepdim=True)
    w = torch.where(valid, s1 * s2, 0.0)
    planes, rest = [], w
    for _ in range(3):
        p = rest.to(torch.bfloat16).float()
        planes.append(p)
        rest = rest - p
    acc_q = sum(p @ k32 for p in planes[::-1])  # W_2 first
    acc_k = sum(p.transpose(-1, -2) @ q32 for p in planes[::-1])
    qa = (q32 + acc_q).to(torch.bfloat16)[..., :kn, :c]
    ka = (k32 + acc_k).to(torch.bfloat16)[..., :kn, :c]
    return qa, ka, w[..., :kn, :kn], torch.stack(planes)[..., :kn, :kn]


@pytest.mark.parametrize("c", [64, 32, 128])
@pytest.mark.parametrize("k", [16, 9, 32])
def test_attention_three_planes_hold_tolerance(k, c):
    from ssf_slam_tpu_torch.ops.attention import attention_body, attention_plain

    rng = np.random.default_rng(100 + 3 * k + c)
    q, kf = (torch.from_numpy(rng.normal(size=(2, 256, k, c), scale=0.4)
                              .astype(np.float32)).to(torch.bfloat16)
             for _ in range(2))
    assert attention_body(torch.bfloat16, k, c) == "mma"
    qa, ka, w, planes = _three_planes(q, kf)
    # W as attention_plain builds it, from the same zero-padded product
    # sliced back to [K, K]: the claim is that padding and masking leave W
    # as it is, and a host's BLAS may block a [K, C] product other than a
    # padded one (K = 9 rounds apart by 1.9e-6 on some CPUs)
    kp, cp = (16 if k <= 16 else 32), next(x for x in (32, 64, 128)
                                           if c <= x)
    pad = [0, cp - c, 0, kp - k]
    q32, k32 = (torch.nn.functional.pad(x.float(), pad) for x in (q, kf))
    s = (q32 @ k32.transpose(-1, -2))[..., :k, :k]
    e1 = torch.exp(s - torch.amax(s, dim=-2, keepdim=True))
    e2 = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    w_plain = (e1 / torch.sum(e1, dim=-2, keepdim=True)) \
        * (e2 / torch.sum(e2, dim=-1, keepdim=True))
    torch.testing.assert_close(w, w_plain, rtol=1e-6, atol=0.0)
    # the planes: bf16 numbers that add up to W, exactly where |W| is at
    # least PLANES_EXACT_FROM, and to within bf16's subnormal step below
    assert torch.equal(planes, planes.to(torch.bfloat16).float())
    total = (planes[0] + planes[1]) + planes[2]
    exact = w.abs() >= PLANES_EXACT_FROM
    assert bool(exact.any())
    assert torch.equal(total[exact], w[exact])
    assert bool(((total - w).abs()[~exact] <= 2.0 ** -133).all())
    # the outputs against attention_plain, within ATTENTION_TOL's rule
    for got, want in zip((qa, ka), attention_plain(q, kf)):
        assert got.dtype == want.dtype == torch.bfloat16
        err, ref = (got.float() - want.float()).abs(), want.float().abs()
        rms = ref.pow(2).mean().sqrt()
        share = (err <= 1e-6 + 2.0 ** -7 * ref).float().mean().item()
        assert share >= 0.9999, share
        assert bool((err <= 2 * 2.0 ** -7 * (ref + rms)).all())


def test_attention_body_by_shape_and_type():
    """The main path's shape [8192, 16, 64] in bf16 takes the tensor-core
    body; float32 and channels past 128 take the CUDA-core body."""
    from ssf_slam_tpu_torch.ops.attention import attention_body

    assert attention_body(torch.bfloat16, 16, 64) == "mma"
    assert attention_body(torch.bfloat16, 32, 128) == "mma"
    assert attention_body(torch.bfloat16, 9, 99) == "mma"
    assert attention_body(torch.float32, 16, 64) == "simt"
    assert attention_body(torch.bfloat16, 16, 129) == "simt"
    assert attention_body(torch.bfloat16, 20, 200) == "simt"
