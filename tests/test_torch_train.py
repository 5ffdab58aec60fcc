"""The port's training slice against the JAX package, on the CPU.

- Flax-mode BatchNorm (train and eval): output and the updated running
  statistics to 1e-6;
- the optimizer chain against optax (clip by global norm 5, decayed
  weights, Adam, the staircase schedule): three steps on identical
  gradient trees, one of them clipped, parameters to 1e-6;
- ``multi_scale_loss`` with class weights (value and gradient), the flow
  and seg metrics, ``compute_label_weights``, and ``fg_oversample`` frames
  byte-identical to the JAX generator's;
- the harness: ``BestTracker``, the ``batcher``'s order, a resume round
  trip, and a checkpoint that ``load_tflow`` serves;
- one whole train step of the small TFlow (tests/torch_ref.py::SMALL_NET:
  banded at level 0, exact below) in float32 from JAX's parameters: loss
  within 1e-5 relative, every gradient leaf within 1e-4 of its norm, the
  new batch statistics within 1e-5. Both sides pick the same neighbours;
  what differs is the sum order of matmuls, softmaxes and segment sums.
  The input is frame pair seed 7: the cost volumes search around queries
  moved by the coarse flow, which the two sides compute to float32
  rounding, and the banded search ranks 13-bit-truncated distances, so on
  some inputs (seeds 3 and 4 of the generator) one near-tied neighbour
  flips and moves a few leaves by 1e-3 to 1e-1 of their norm. The JAX
  step is committed (``train_small_ref.npz``: live, its interpret-mode
  Pallas compile took 40 s of the suite's clock, which JAX's persistent
  cache cannot keep): the loss, the batch statistics, and per gradient
  leaf its norm and a 64-bucket CountSketch
  (``torch_ref.count_sketch``), which is linear, so the sketch of the
  port's gradient minus JAX's sketch is the sketch of the difference,
  whose norm it gives to within about 18 %.

The card's train phase (chip_smoke.py) holds the port's f32 train step at
full width against ``tests/fixtures/torch_port/ssf_train_ref.npz``: JAX's
loss, gradient norm of every leaf and new batch statistics for one batch
of the first two bench pairs (8192 points, committed weights, Pallas in
interpret mode), made by

      JAX_PLATFORMS=cpu python tests/test_torch_train.py --make-fixture

which makes ``train_small_ref.npz`` too.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402

torch.set_num_threads(1)

KEYS = ("pos1", "pos2", "gt", "mask1", "s_fg_mask")
TRAIN_REF = os.path.join(torch_ref.FIXTURE_DIR, "ssf_train_ref.npz")
SMALL_REF = os.path.join(torch_ref.FIXTURE_DIR, "train_small_ref.npz")


def make_small_fixture(path: str = SMALL_REF) -> None:
    """JAX's f32 train step of the small TFlow on ``small_batch``."""
    batch, lw = _small_batch()
    loss, grads, stats = torch_ref.jax_train_step(
        torch_ref.SMALL_NET, torch_ref.load_npz_variables(), batch, lw)
    np.savez(path, loss=np.float32(loss),
             **{f"grad_norm/{k}": np.float64(np.linalg.norm(v))
                for k, v in grads.items()},
             **{f"grad_sketch/{k}": np.float32(
                 torch_ref.count_sketch(v, k)) for k, v in grads.items()},
             **stats)
    print(f"wrote {path}: loss {loss:.6f}")


def make_fixture(path: str = TRAIN_REF) -> None:
    """JAX's f32 train step at full width on the first two bench pairs."""
    from ssf_slam_tpu.data.carla import compute_label_weights
    from ssf_slam_tpu.data.synthetic import generate_sequence

    frames = generate_sequence(n_frames=32, n_points=8192, seed=0,
                               noise=0.004, n_moving=4)[:2]
    lw = compute_label_weights(frames)
    batch = {k: np.stack([f[k] for f in frames]).astype(np.float32)
             for k in KEYS}
    net = dict(npoint=8192, joint_seg=True, dtype="float32",
               neighbor_backend="banded")
    loss, grads, stats = torch_ref.jax_train_step(
        net, torch_ref.load_npz_variables(), batch,
        (float(lw[0]), float(lw[1])))
    np.savez(path, loss=np.float32(loss), label_weights=lw,
             **{f"grad_norm/{k}": np.float32(np.linalg.norm(v))
                for k, v in grads.items()},
             **stats)
    print(f"wrote {path}: loss {loss:.6f}, {len(grads)} gradient leaves")


def test_batchnorm_train_and_eval_match_flax():
    import flax.linen as fnn

    from ssf_slam_tpu_torch.models.layers import BatchNorm

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 64, 16, 8)) * 3 + 1).astype(np.float32)
    x[..., 5] = 0.25  # a dead channel: variance 0
    scale, bias, mean = (rng.normal(size=8).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 2, 8).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    bn = BatchNorm(8)
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    for train in (True, False):
        fbn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                            epsilon=1e-3)
        want, upd = fbn.apply(variables, jnp.asarray(x),
                              mutable=["batch_stats"])
        got = bn.train(train)(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        stats = upd["batch_stats"] if train else variables["batch_stats"]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats["var"]), rtol=1e-6,
                                   atol=1e-7)
        if train:  # the next call sees the updated statistics, as Flax's
            variables = {"params": variables["params"],
                         "batch_stats": upd["batch_stats"]}


def test_optimizer_chain_matches_optax():
    import optax

    from ssf_slam_tpu.train.trainer import exp_decay_lr as j_lr
    from ssf_slam_tpu_torch.config import TrainConfig
    from ssf_slam_tpu_torch.train.trainer import Optimizer, exp_decay_lr

    cfg = TrainConfig(lr=1e-3, batch_size=4, decay_steps=8, lr_min=6e-4)
    rng = np.random.default_rng(1)
    shapes = {"a": (16, 8), "b": (8,), "c": (3, 5, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    # the second tree's global norm is above 5: it is clipped
    grads = [{k: (rng.normal(size=s) * sc).astype(np.float32)
              for k, s in shapes.items()} for sc in (0.1, 3.0, 0.2)]
    from ssf_slam_tpu.config import TrainConfig as JTrainConfig

    jcfg = JTrainConfig(lr=1e-3, batch_size=4, decay_steps=8, lr_min=6e-4)
    tx = optax.chain(
        optax.clip_by_global_norm(5.0), optax.add_decayed_weights(1e-4),
        optax.scale_by_adam(),
        optax.scale_by_learning_rate(lambda c: j_lr(c, jcfg, 4)))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    opt = Optimizer(cfg, 4)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = opt.init(tp)
    norms = []
    for step, g in enumerate(grads):
        assert exp_decay_lr(step, cfg, 4) == pytest.approx(
            float(j_lr(step, jcfg, 4)), rel=1e-6)
        norms.append(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                 for v in g.values())))
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {k}")
    assert norms[1] > 5 > max(norms[0], norms[2])
    assert tstate.count == 3


def _loss_inputs(rng, b=2, n=64):
    sizes = (n, n // 2, n // 4, n // 8)
    preds = [rng.normal(size=(b, s, 4)).astype(np.float32) for s in sizes]
    gt = rng.normal(size=(b, n, 3)).astype(np.float32)
    mask = (rng.uniform(size=(b, n)) > 0.2).astype(np.float32)
    seg = (rng.uniform(size=(b, n)) > 0.7).astype(np.float32)
    fps = [np.sort(rng.choice(sizes[i], sizes[i + 1], replace=False))[None]
           .repeat(b, 0) for i in range(3)]
    return preds, gt, mask, seg, fps


def test_multi_scale_loss_matches_jax():
    from ssf_slam_tpu.models.tflow import multi_scale_loss as j_loss
    from ssf_slam_tpu_torch.models.tflow import multi_scale_loss

    preds, gt, mask, seg, fps = _loss_inputs(np.random.default_rng(2))
    kw = dict(seg_weight=0.7, seg_class_weights=(0.4, 1.6))
    want, jg = jax.value_and_grad(lambda p: j_loss(
        p, jnp.asarray(gt), jnp.asarray(mask), [jnp.asarray(i) for i in fps],
        seg_labels=jnp.asarray(seg), **kw))([jnp.asarray(p) for p in preds])
    tp = [torch.from_numpy(p).requires_grad_() for p in preds]
    got = multi_scale_loss(tp, torch.from_numpy(gt), torch.from_numpy(mask),
                           [torch.from_numpy(i) for i in fps],
                           seg_labels=torch.from_numpy(seg), **kw)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    got.backward()
    for t, j in zip(tp, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-7)


def test_flow_and_seg_metrics_match_jax():
    from ssf_slam_tpu.models import metrics as jm
    from ssf_slam_tpu_torch.models import metrics as tm

    rng = np.random.default_rng(3)
    gt = rng.normal(size=(2, 256, 3)).astype(np.float32)
    pred = gt + rng.normal(0, 0.1, gt.shape).astype(np.float32)
    mask = (rng.uniform(size=(2, 256)) > 0.1).astype(np.float32)
    logit = rng.normal(size=(2, 256)).astype(np.float32)
    label = (rng.uniform(size=(2, 256)) > 0.6).astype(np.float32)
    want = {**jm.flow_metrics(*map(jnp.asarray, (pred, gt, mask))),
            **jm.seg_metrics(*map(jnp.asarray, (logit, label, mask)))}
    got = {**tm.flow_metrics(*map(torch.from_numpy, (pred, gt, mask))),
           **tm.seg_metrics(*map(torch.from_numpy, (logit, label, mask)))}
    assert got.keys() == want.keys()
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k


def _frames(n_points=1024, **kw):
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    return generate_sequence(n_frames=2, n_points=n_points, seed=7,
                             noise=0.004, n_moving=4, **kw)


def test_fg_oversample_frames_byte_identical_and_label_weights():
    from ssf_slam_tpu.data.carla import compute_label_weights as j_lw
    from ssf_slam_tpu.data.synthetic import generate_sequence as j_gen
    from ssf_slam_tpu_torch.data.carla import compute_label_weights

    kw = dict(n_frames=3, n_points=2048, seed=5, noise=0.004, n_moving=8,
              fg_oversample=600)
    jf = j_gen(**kw)
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    tf = generate_sequence(**kw)
    for a, b in zip(jf, tf):
        for key in ("pos1", "pos2", "gt", "ego_flow", "s_fg_mask",
                    "t_fg_mask", "mask1", "mask2"):
            assert a[key].tobytes() == b[key].tobytes(), key
    # oversampling really moved the mix towards the movers
    plain = generate_sequence(**{**kw, "fg_oversample": 0})
    assert (sum(f["s_fg_mask"].sum() for f in tf)
            > sum(f["s_fg_mask"].sum() for f in plain))
    np.testing.assert_array_equal(compute_label_weights(tf, max_items=2),
                                  j_lw(jf, max_items=2))


def test_best_tracker_and_criterion_match_jax():
    from ssf_slam_tpu.train import harness as jh
    from ssf_slam_tpu_torch.train import harness as th

    assert th.parse_best_criterion("epe") == jh.parse_best_criterion("epe")
    assert th.parse_best_criterion("gated:0.6") == 0.6
    with pytest.raises(ValueError):
        th.parse_best_criterion("iou")
    seq = [dict(epe3d=0.3, iou_moving=0.5), dict(epe3d=0.2, iou_moving=0.7),
           dict(epe3d=0.1, iou_moving=0.55), dict(epe3d=0.15, iou_moving=0.9)]
    for gate in (0.0, 0.6, 0.95):
        t, j = th.BestTracker(gate), jh.BestTracker(gate)
        assert [t.update(m, e) for e, m in enumerate(seq)] == [
            j.update(m, e) for e, m in enumerate(seq)]
        assert (t.best_epe, t.best_epoch, t.never_qualified) == (
            j.best_epe, j.best_epoch, j.never_qualified)


def test_batcher_order_matches_jax():
    from ssf_slam_tpu.train.harness import batcher as j_batcher
    from ssf_slam_tpu_torch.train.harness import batcher

    frames = [{k: np.full((2,), i, np.float32) for k in KEYS}
              for i in range(11)]
    tg, jg = batcher(frames, 3, [7]), j_batcher(frames, 3, [7])
    for _ in range(2):  # the seed advances per epoch
        tb, jb = list(tg()), list(jg())
        assert len(tb) == len(jb) == 3
        for a, b in zip(tb, jb):
            for k in KEYS:
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the small TFlow: one train step against JAX, checkpoints and resume
# ---------------------------------------------------------------------------


def _small_batch():
    from ssf_slam_tpu_torch.data.carla import compute_label_weights

    frames = _frames()
    lw = compute_label_weights(frames)
    batch = {k: np.stack([f[k] for f in frames]).astype(np.float32)
             for k in KEYS}
    return batch, (float(lw[0]), float(lw[1]))


@pytest.fixture(scope="module")
def small_batch():
    return _small_batch()


def _small_model():
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.weights import load_tflow

    return load_tflow(FlowNetConfig(**torch_ref.SMALL_NET), device="cpu")


@pytest.fixture(scope="module")
def small_step(small_batch):
    """The port's loss, flat Flax gradients and new batch statistics of one
    f32 train step of the small TFlow from the committed weights, and the
    committed JAX step."""
    from ssf_slam_tpu_torch.config import LossConfig
    from ssf_slam_tpu_torch.ops import neighbors
    from ssf_slam_tpu_torch.train.trainer import forward_loss, to_device
    from ssf_slam_tpu_torch.weights import to_flax

    batch, lw = small_batch
    model = _small_model().train()
    params = dict(model.named_parameters())
    neighbors.SEGMENT_SUMS["backward"] = 0
    loss, _ = forward_loss(model, to_device(batch, "cpu"),
                           LossConfig(seg_class_weights=lw))
    grads = torch.autograd.grad(loss, list(params.values()))
    n_sums = neighbors.SEGMENT_SUMS["backward"]
    got_grads = to_flax(model, dict(zip(params, grads)))
    stats = {k: v for k, v in to_flax(model).items()
             if k.startswith("batch_stats/")}
    with np.load(SMALL_REF) as z:
        want = {k: z[k] for k in z.files}
    return (float(loss), got_grads, stats, n_sums), want


def test_small_train_step_loss_matches_jax(small_step):
    (loss, _, _, n_sums), want = small_step
    assert loss == pytest.approx(float(want["loss"]), rel=1e-5)
    # banded at level 0 (1024 x 1024): the cost volume's two groupings and
    # its regroup sum segments in the backward; the warping's IDW gets no
    # cotangent (the warped cloud only feeds a kNN's indices)
    assert n_sums == 3


def test_small_train_step_gradients_match_jax(small_step):
    (_, grads, _, _), want = small_step
    norms = {k[len("grad_norm/"):]: float(v) for k, v in want.items()
             if k.startswith("grad_norm/")}
    assert grads.keys() == norms.keys()
    # the weightnets' output biases shift every logit of a per-segment
    # softmax alike: their gradient is zero but for rounding (norms of
    # 1e-8 to 1e-7), so every leaf also gets a floor of 1e-6 of the
    # largest leaf norm
    floor = 1e-6 * max(norms.values())
    for k, w in norms.items():
        assert abs(np.linalg.norm(grads[k]) - w) <= 1e-4 * w + floor, k
        # the sketch of the difference measures its norm (to ~18 %)
        err = np.linalg.norm(torch_ref.count_sketch(grads[k], k)
                             - want[f"grad_sketch/{k}"])
        assert err <= 1e-4 * w + floor, (k, err, w)


def test_small_train_step_batch_stats_match_jax(small_step):
    (_, _, stats, _), want = small_step
    assert stats.keys() == {k for k in want if k.startswith("batch_stats/")}
    for k, v in stats.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_train_step_checkpoint_resume_and_serving(small_batch, tmp_path):
    """Two bf16 train steps, the second with frozen BatchNorm; a resume
    round trip restores parameters, moments and step; the ``best.npz``
    checkpoint loads into ``load_tflow`` as an eval-mode serving model."""
    from ssf_slam_tpu_torch.config import (FlowNetConfig, LossConfig,
                                           TrainConfig)
    from ssf_slam_tpu_torch.train import harness
    from ssf_slam_tpu_torch.train.trainer import (
        create_train_state,
        load_checkpoint,
        make_train_step,
        save_checkpoint,
        to_device,
    )
    from ssf_slam_tpu_torch.weights import load_tflow, to_flax

    batch, lw = small_batch
    batch = to_device({k: v[:1] for k, v in batch.items()}, "cpu")
    cfg = FlowNetConfig(**{**torch_ref.SMALL_NET, "dtype": "bfloat16"})
    model = load_tflow(cfg, device="cpu")
    assert not model.training and model.sa1.PointMLP_0.Dense_0_part0 \
        .weight.dtype == torch.float32
    tcfg = TrainConfig(lr=1e-4, batch_size=1)
    state, tx = create_train_state(model, tcfg)
    before = to_flax(model)
    step = make_train_step(model, tx, tcfg, LossConfig(seg_class_weights=lw))
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"])) and m["lr"] == 1e-4
    after1 = to_flax(model)
    frozen = make_train_step(model, tx, tcfg, LossConfig(), freeze_bn=True)
    state, _ = frozen(state, batch)
    after2 = to_flax(model)
    stats = [k for k in before if k.startswith("batch_stats/")]
    # train mode moves the running statistics (the committed model's dead
    # layers, whose inputs are all zero, keep theirs), frozen BatchNorm
    # keeps them all
    assert sum(not np.array_equal(before[k], after1[k]) for k in stats) > 20
    for k in stats:
        np.testing.assert_array_equal(after1[k], after2[k])
    assert any(not np.array_equal(after1[k], after2[k]) for k in after1
               if k.startswith("params/"))
    assert state.step == 2 and state.opt_state.count == 2

    harness.save_resume(str(tmp_path), state, 3, 0.25)
    ckpt = save_checkpoint(str(tmp_path), state)
    fresh = load_tflow(cfg, device="cpu")
    fstate, _ = create_train_state(fresh, tcfg)
    fstate, epoch, best = harness.load_resume(str(tmp_path), fstate)
    assert (epoch, best, fstate.step, fstate.opt_state.count) == (4, 0.25, 2,
                                                                  2)
    restored = to_flax(fresh)
    for k in after2:
        np.testing.assert_array_equal(restored[k], after2[k])
    for part in ("mu", "nu"):
        for k, v in getattr(state.opt_state, part).items():
            np.testing.assert_array_equal(
                getattr(fstate.opt_state, part)[k].numpy(), v.numpy())
    served = load_tflow(cfg, path=ckpt, device="cpu")
    assert not served.training
    with torch.inference_mode():
        flows, _ = served(batch["pos1"], batch["pos2"])
    assert bool(torch.isfinite(flows[0].float()).all())
    other, _ = create_train_state(load_tflow(cfg, device="cpu"), tcfg)
    load_checkpoint(str(tmp_path), other)
    for k, v in to_flax(other.model).items():
        np.testing.assert_array_equal(v, after2[k])


def test_train_scene_flow_loop_writes_best(tmp_path):
    """One epoch of the loop over two single-pair batches and an eval pass:
    the history, a RunLogger's files and a best.npz of the snapshot."""
    from ssf_slam_tpu_torch.config import FlowNetConfig, TrainConfig
    from ssf_slam_tpu_torch.models.tflow import TFlow
    from ssf_slam_tpu_torch.train.harness import batcher
    from ssf_slam_tpu_torch.train.trainer import train_scene_flow
    from ssf_slam_tpu_torch.weights import load_npz

    frames = _frames()
    model = TFlow(FlowNetConfig(**torch_ref.SMALL_NET))
    best, hist = train_scene_flow(
        model, batcher(frames, 1, [0]), batcher(frames[:1], 1, [1]),
        TrainConfig(lr=1e-4, batch_size=1), epochs=1,
        ckpt_dir=str(tmp_path), run_dir=str(tmp_path / "run"),
        device="cpu", generator=torch.Generator().manual_seed(0))
    assert len(hist["train_loss"]) == len(hist["eval_epe"]) == 1
    assert np.isfinite(hist["train_loss"][0]) and "eval_miou" in hist
    saved = load_npz(str(tmp_path / "best.npz"))
    assert saved.keys() == best.keys()
    for k in best:
        np.testing.assert_array_equal(saved[k], best[k])
    assert (tmp_path / "run" / "metrics.jsonl").read_text().count("\n") == 1


def test_dense_serving_copy_follows_the_masters():
    from ssf_slam_tpu_torch.models.layers import Dense

    d = Dense(4, 3, dtype=torch.bfloat16)
    with torch.no_grad():
        d.weight.copy_(torch.arange(12.0).reshape(3, 4) / 7)
        d.bias.copy_(torch.tensor([0.1, 0.2, 0.3]))
    x = torch.ones(2, 4)
    with torch.inference_mode():
        y1 = d(x)
    assert y1.dtype == torch.bfloat16
    want = torch.nn.functional.linear(x.bfloat16(), d.weight.bfloat16(),
                                      d.bias.bfloat16())
    assert torch.equal(y1, want)
    with torch.no_grad():
        d.weight.add_(1.0)  # an optimizer step: the cached copy is stale
        y2 = d(x)
    assert torch.equal(y2, torch.nn.functional.linear(
        x.bfloat16(), d.weight.bfloat16(), d.bias.bfloat16()))
    y3 = d(x)  # with autograd: cast per call, gradient to the masters
    y3.float().sum().backward()
    assert d.weight.grad.dtype == torch.float32


if __name__ == "__main__":
    if sys.argv[1:] != ["--make-fixture"]:
        sys.exit("usage: python tests/test_torch_train.py --make-fixture")
    jax.config.update("jax_platforms", "cpu")
    make_small_fixture()
    make_fixture()
