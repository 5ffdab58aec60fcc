"""The neighbour engine's last three banded kernels, the fused attention and
the whole dispatch surface's gradients, the port against the JAX package.

Kernels (plain PyTorch versions against the Pallas kernels in interpret
mode, tests/test_banded.py's lidar-cloud shape, Morton-sorted under a shared
box, the plan made by the port and checked equal to JAX's):
- ``knn`` and ``knn_group2``: sqdist, idx and groups exact;
- ``scatter_add``: 1e-6 relative + 1e-6 absolute in float32 (the Pallas
  kernel sums each tile as a one-hot matmul, the port row by row); bf16
  values are exact in float32, so the same;
- ``attention_plain`` against ``attention_fused``: float32 to 1e-5; bf16
  within one bf16 step of the value (2^-7 relative + 1e-6), as the two sum
  the products in different orders before the one rounding.

Gradients: every ``nn_*`` dispatcher of the port against ``jax.grad``
through the JAX custom VJPs (banded path) and through XLA (exact path), of
sum(output * R) for a fixed random R, in float32 to 1e-5 of each gradient's
largest value; the inputs a JAX VJP gives no gradient get none. In bf16 the
port sums each segment in float32 and rounds once (within one bf16 step of
the float32 sum), JAX sums in bf16: within four steps of (|value| + rms)
of the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssf_slam_tpu.ops import attention as jatt
from ssf_slam_tpu.ops import banded as jbanded
from ssf_slam_tpu.ops import neighbors as jnb
from ssf_slam_tpu_torch.ops import attention as tatt
from ssf_slam_tpu_torch.ops import banded as tbanded
from ssf_slam_tpu_torch.ops import neighbors as tnb

torch.set_num_threads(1)

B, N, M, K, C = 2, 1024, 2048, 8, 16
PARAMS = (256, 256, 3)
EXT = 64.0


@pytest.fixture(autouse=True, scope="module")
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _lidar_cloud(rng, n):
    r = rng.uniform(3, 28, n)
    th = rng.uniform(0, 2 * np.pi, n)
    z = rng.normal(0, 1.5, n)
    return np.stack([r * np.cos(th), r * np.sin(th), z], 1).astype(np.float32)


def _sorted_pair(rng, n, m):
    q0 = np.stack([_lidar_cloud(rng, n) for _ in range(B)])
    p0 = np.stack([_lidar_cloud(rng, m) for _ in range(B)])
    box = tnb.cloud_box(torch.from_numpy(q0), torch.from_numpy(p0))
    q, _ = tnb.morton_sort(torch.from_numpy(q0), box=box)
    p, _ = tnb.morton_sort(torch.from_numpy(p0), box=box)
    return q, p, box


def _jbox(box):
    return jnp.asarray(box[0].numpy()), jnp.asarray(box[1].numpy())


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    q, p, box = _sorted_pair(rng, N, M)
    # a second, row-aligned target (a warped copy) and a query near q
    pb = p + torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32))
    qb = q + torch.from_numpy(rng.normal(0, 0.05, q.shape).astype(np.float32))
    feats = torch.from_numpy(rng.normal(size=(B, M, C)).astype(np.float32))
    plan = tnb.make_plan(q, p, PARAMS, EXT, box)
    jplan = jnb.make_plan(jnp.asarray(q.numpy()), jnp.asarray(p.numpy()),
                          PARAMS, EXT, _jbox(box))
    np.testing.assert_array_equal(plan[0].numpy(), np.asarray(jplan[0]))
    return dict(q=q, p=p, qb=qb, pb=pb, feats=feats, plan=plan, jplan=jplan,
                box=box)


def _jplan_b(c, b):
    return c["jplan"][0][b], c["jplan"][1][b]


def test_knn_plain_matches_pallas(case):
    c = case
    d, idx = tbanded.knn(c["q"], c["p"], K, c["plan"], PARAMS)
    assert tbanded.LAUNCHES["knn"] == 0  # CPU takes the plain version
    for b in range(B):
        jd, ji = jbanded.banded_knn(jnp.asarray(c["q"][b].numpy()),
                                    jnp.asarray(c["p"][b].numpy()), K,
                                    plan=_jplan_b(c, b))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(d[b].numpy(), np.asarray(jd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knn_group2_plain_matches_pallas(case, dtype):
    c = case
    feats = c["feats"].to(getattr(torch, dtype))
    got = tbanded.knn_group2(c["q"], c["qb"], c["p"], c["pb"], feats, K,
                             c["plan"], PARAMS)
    jf = jnp.asarray(c["feats"].numpy()).astype(getattr(jnp, dtype))
    for b in range(B):
        want = jbanded.banded_knn_group2(
            *(jnp.asarray(c[k][b].numpy()) for k in ("q", "qb", "p", "pb")),
            jf[b], K, plan=_jplan_b(c, b))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].float().numpy(),
                                          np.asarray(w.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_add_plain_matches_pallas(case, dtype):
    c = case
    _, idx, _ = tbanded.knn_group(c["q"], c["p"], c["feats"], K, c["plan"],
                                  PARAMS)
    idx = idx.clone()
    idx[:, :256:37, 0] = M - 1  # out of the first tile's band: dropped
    vals = np.random.default_rng(3).normal(size=(B, N, K, C))
    tv = torch.from_numpy(vals.astype(np.float32)).to(getattr(torch, dtype))
    out = tbanded.scatter_add(idx, tv, c["plan"], PARAMS, M)
    assert out.dtype == torch.float32
    jv = jnp.asarray(vals, jnp.float32).astype(getattr(jnp, dtype))
    for b in range(B):
        jo = jbanded.banded_scatter_add(jnp.asarray(idx[b].numpy()), jv[b],
                                        _jplan_b(c, b), M)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(jo),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_pallas(dtype):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 256, 16, 32)).astype(np.float32)
    k = rng.normal(size=(2, 256, 16, 32)).astype(np.float32)
    tq, tk = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k))
    got = tatt.attention_fused(tq, tk)
    assert tatt.LAUNCHES["attention"] == 0
    jq, jk = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, k))
    want = jatt.attention_fused(jq, jk)
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            assert (np.abs(g - w) <= 1e-6 + 2.0 ** -7 * np.abs(w)).all()


def test_attention_fused_grad_relinearises_xla():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 256, 8, 16)).astype(np.float32)
    k = rng.normal(size=(1, 256, 8, 16)).astype(np.float32)
    r = rng.normal(size=(2, 1, 256, 8, 16)).astype(np.float32)

    def jloss(a, b):
        qa, ka = jatt.attention_fused(a, b)
        return jnp.sum(qa * r[0]) + jnp.sum(ka * r[1])

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    tq, tk = (torch.from_numpy(a).requires_grad_() for a in (q, k))
    qa, ka = tatt.attention_fused(tq, tk)
    (torch.sum(qa * torch.from_numpy(r[0]))
     + torch.sum(ka * torch.from_numpy(r[1]))).backward()
    for g, w in zip((tq.grad, tk.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# gradients of the dispatch surface
# ---------------------------------------------------------------------------


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


def _grads(fn_t, fn_j, args, wrt, seed):
    """Gradients of sum(out * R) with respect to ``wrt`` (argument indices)
    in the port and in JAX; R is fixed random per output."""
    rng = np.random.default_rng(seed)
    targs = [torch.from_numpy(a).requires_grad_(i in wrt)
             if isinstance(a, np.ndarray) and a.dtype == np.float32
             else a for i, a in enumerate(args)]
    outs = fn_t(*targs)
    rs = [rng.normal(size=o.shape).astype(np.float32) for o in outs]
    loss = sum(torch.sum(o.float() * torch.from_numpy(r))
               for o, r in zip(outs, rs))
    tg = (torch.autograd.grad(loss, [targs[i] for i in wrt],
                              allow_unused=True)
          if loss.requires_grad else [None] * len(wrt))

    def jloss(*diff):
        a = list(args)
        for i, v in zip(wrt, diff):
            a[i] = v
        a = [jnp.asarray(v) if isinstance(v, np.ndarray) else v for v in a]
        return sum(jnp.sum(o.astype(jnp.float32) * r)
                   for o, r in zip(fn_j(*a), rs))

    jg = jax.grad(jloss, argnums=tuple(range(len(wrt))))(
        *(jnp.asarray(args[i]) for i in wrt))
    return [None if g is None else g.numpy() for g in tg], jg


def _inputs(c, exact: bool):
    """(query, points, feats) numpy: the banded case's sorted clouds, or a
    small pair that fails band_params."""
    if not exact:
        return c["q"].numpy(), c["p"].numpy(), c["feats"].numpy()
    rng = np.random.default_rng(7)
    q = np.stack([_lidar_cloud(rng, 256) for _ in range(B)])
    p = np.stack([_lidar_cloud(rng, 512) for _ in range(B)])
    return q, p, rng.normal(size=(B, 512, C)).astype(np.float32)


def _box(c, exact):
    return None if exact else c["box"]


@pytest.mark.parametrize("exact", [False, True], ids=["banded", "exact"])
def test_nn_knn_grad(case, exact):
    q, p, _ = _inputs(case, exact)
    if not exact:
        # the banded distances carry no gradient (JAX stops it; its Pallas
        # kNN has no derivative at all): the forward must agree
        tq, tp = (torch.from_numpy(a).requires_grad_() for a in (q, p))
        d, idx = tnb.nn_knn(tq, tp, K, "banded", EXT, box=case["box"])
        jd, ji = jnb.nn_knn(jnp.asarray(q), jnp.asarray(p), K, "banded", EXT,
                            box=_jbox(case["box"]))
        assert not d.requires_grad
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        return
    tg, jg = _grads(lambda a, b: tnb.nn_knn(a, b, K, "banded", EXT)[:1],
                    lambda a, b: jnb.nn_knn(a, b, K, "banded", EXT)[:1],
                    (q, p), (0, 1), 11)
    _close(tg[0], jg[0], "query")
    _close(tg[1], jg[1], "points")


@pytest.mark.parametrize("exact", [False, True], ids=["banded", "exact"])
def test_nn_knn_group_grad(case, exact):
    q, p, f = _inputs(case, exact)
    box = _box(case, exact)
    jbox = None if box is None else _jbox(box)
    tnb.SEGMENT_SUMS["backward"] = 0
    tg, jg = _grads(
        lambda a, b, ft: tnb.nn_knn_group(a, b, ft, K, "banded", EXT,
                                          box=box)[1:2],
        lambda a, b, ft: jnb.nn_knn_group(a, b, ft, K, "banded", EXT,
                                          box=jbox)[1:2],
        (q, p, f), (0, 1, 2), 12)
    assert tg[0] is None and tg[1] is None
    assert not np.asarray(jg[0]).any() and not np.asarray(jg[1]).any()
    _close(tg[2], jg[2], "feats")
    assert tnb.SEGMENT_SUMS["backward"] == (0 if exact else 1)


@pytest.mark.parametrize("exact", [False, True], ids=["banded", "exact"])
def test_nn_knn_group2_grad(case, exact):
    c = case
    q, p, f = _inputs(c, exact)
    if exact:
        rng = np.random.default_rng(8)
        qb = q + rng.normal(0, 0.05, q.shape).astype(np.float32)
        pb = p + rng.normal(0, 0.05, p.shape).astype(np.float32)
    else:
        qb, pb = c["qb"].numpy(), c["pb"].numpy()
    box = _box(c, exact)
    jbox = None if box is None else _jbox(box)
    tg, jg = _grads(
        lambda a, b, pa, pbb, ft: [o for i, o in enumerate(tnb.nn_knn_group2(
            a, b, pa, pbb, ft, K, "banded", EXT, box=box)) if i in (1, 3)],
        lambda a, b, pa, pbb, ft: [o for i, o in enumerate(jnb.nn_knn_group2(
            a, b, pa, pbb, ft, K, "banded", EXT, box=jbox)) if i in (1, 3)],
        (q, qb, p, pb, f), (4,), 13)
    _close(tg[0], jg[0], "feats")


def test_nn_regroup_grad(case):
    c = case
    _, idx, _ = tbanded.knn_group(c["q"], c["p"], c["feats"], K, c["plan"],
                                  PARAMS)
    g2 = np.random.default_rng(9).normal(size=(B, M, 7)).astype(np.float32)
    tg, jg = _grads(
        lambda ft: [tnb.nn_regroup(ft, idx, c["plan"], PARAMS)],
        lambda ft: [jnb.nn_regroup(ft, jnp.asarray(idx.numpy()), c["jplan"],
                                   PARAMS)],
        (g2,), (0,), 14)
    _close(tg[0], jg[0], "feats")


@pytest.mark.parametrize("exact", [False, True], ids=["banded", "exact"])
def test_nn_knn_idw_grad(case, exact):
    q, p, f = _inputs(case, exact)
    box = _box(case, exact)
    jbox = None if box is None else _jbox(box)
    tg, jg = _grads(
        lambda a, b, ft: [tnb.nn_knn_idw(a, b, ft, 5, "banded", EXT,
                                         box=box)],
        lambda a, b, ft: [jnb.nn_knn_idw(a, b, ft, 5, "banded", EXT,
                                         box=jbox)],
        (q, p, f), (0, 1, 2), 15)
    _close(tg[2], jg[2], "fields")
    if exact:  # the exact path differentiates through the IDW weights
        _close(tg[0], jg[0], "query")
        _close(tg[1], jg[1], "points")
    else:
        assert tg[0] is None and tg[1] is None
        assert not np.asarray(jg[0]).any() and not np.asarray(jg[1]).any()


@pytest.mark.parametrize("exact", [False, True], ids=["banded", "exact"])
def test_nn_scatter_softmax_sum_grad(case, exact):
    c = case
    rng = np.random.default_rng(16)
    if exact:
        n, m = 256, 512
        idx = rng.integers(0, m, size=(B, n, K))
        plan = jplan = params = None
    else:
        n, m = N, M
        _, tidx, _ = tbanded.knn_group(c["q"], c["p"], c["feats"], K,
                                       c["plan"], PARAMS)
        idx = tidx.numpy()
        plan, jplan, params = c["plan"], c["jplan"], PARAMS
    vals = rng.normal(size=(B, n, K, C)).astype(np.float32)
    w = rng.normal(size=(B, n, K)).astype(np.float32)
    ti, ji = torch.from_numpy(idx).to(torch.int32), jnp.asarray(idx,
                                                                jnp.int32)
    tg, jg = _grads(
        lambda v, ww: [tnb.nn_scatter_softmax_sum(v, ww, ti, m, plan,
                                                  params)],
        lambda v, ww: [jnb.nn_scatter_softmax_sum(v, ww, ji, m, jplan,
                                                  params)],
        (vals, w), (0, 1), 17)
    _close(tg[0], jg[0], "vals")
    _close(tg[1], jg[1], "logits")


def test_nn_knn_group_grad_bf16(case):
    """bf16 features: the port sums each segment in float32 and rounds
    once, so it is within one bf16 step of the float32 sum of the same bf16
    cotangents; JAX accumulates in bf16, a few steps away from both."""
    c = case
    f = c["feats"].to(torch.bfloat16).requires_grad_()
    _, grouped, _, _ = tnb.nn_knn_group(c["q"], c["p"], f, K, "banded", EXT,
                                        box=c["box"])
    r = np.random.default_rng(18).normal(size=grouped.shape).astype(
        np.float32)
    rb = torch.from_numpy(r).to(torch.bfloat16)
    (g,) = torch.autograd.grad(grouped, f, rb)
    assert g.dtype == torch.bfloat16

    def grad_of(feats, ct):
        def fwd(ft):
            return jnb.nn_knn_group(
                jnp.asarray(c["q"].numpy()), jnp.asarray(c["p"].numpy()), ft,
                K, "banded", EXT, box=_jbox(c["box"]))[1]

        _, vjp = jax.vjp(fwd, feats)
        return np.asarray(vjp(ct)[0].astype(jnp.float32))

    jf = jnp.asarray(c["feats"].numpy())
    ct = jnp.asarray(rb.float().numpy())
    want32 = grad_of(jf, ct)  # float32 sums of the bf16 cotangents
    want16 = grad_of(jf.astype(jnp.bfloat16), ct.astype(jnp.bfloat16))
    got = g.float().numpy()
    assert (np.abs(got - want32) <= 2.0 ** -7 * np.abs(want32) + 1e-6).all()
    rms = np.sqrt(np.mean(want16 ** 2))
    assert (np.abs(got - want16) <= 4 * 2.0 ** -7 * (np.abs(want16)
                                                      + rms)).all()
