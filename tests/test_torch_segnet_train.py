"""SegNet training (``ssf_slam_tpu_torch/train/train_segnet.py``) against
scripts/train_segnet.py's step, on the CPU.

- One f32 train step of a small SegNet (the committed ``segnet_r3``
  weights, sa_npoints (256, 64), 2 x 1024 points, the exact "xla"
  neighbour backend the script trains on) with the same flow-noise array
  in both packages, against a committed JAX step
  (``segnet_train_small_ref.npz``; the card's chip check holds the same
  step against it): the loss within 1e-4 relative, each parameter leaf's
  gradient norm within 1e-3 relative (and each element within 1e-3 of the
  norm), the new batch statistics within 1e-4; the port's Adam on JAX's
  gradient within 1e-6 of JAX's new parameters, and the port's whole
  step within 1e-5 of them wherever |g| >= 1e-6 (below, Adam's first
  step lr g / (|g| + eps) takes the sign of the gradient's rounding).
- ``trainer.Adam`` against ``optax.adam``: three steps on random leaves,
  within 1e-6.
- The eval metrics (the IoU of both classes, the accuracy) on a fixed
  input and noise, equal to the JAX script's ``eval_step`` (its body: a
  closure of the script's ``main``).
- The script on the CPU: one epoch of a tiny corpus writes
  ``metrics.jsonl``, ``config.json`` and a ``best.npz`` that
  ``weights.load_segnet`` loads.

The fixture is made by

    JAX_PLATFORMS=cpu python tests/test_torch_segnet_train.py --make-fixture
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402
from test_torch_segnet import SEG_NPZ  # noqa: E402

torch.set_num_threads(1)

TRAIN_REF = os.path.join(torch_ref.FIXTURE_DIR, "segnet_train_small_ref.npz")
SMALL_TRAIN_SEG = dict(sa_npoints=(256, 64))
N_POINTS, LR, MAX_SIGMA = 1024, 1e-3, 0.05
LOSS_RTOL, GRAD_RTOL, STATS_TOL, PARAM_TOL = 1e-4, 1e-3, 1e-4, 1e-5
ADAM_G_FLOOR = 1e-6  # |g| above which Adam's first step is well set


def _batch() -> dict:
    """Two frames of a generated sequence as the script batches them, and
    the flow noise of one step (sigma 0.03, from a seed)."""
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    frames = generate_sequence(n_frames=2, n_points=N_POINTS, seed=5,
                               noise=0.004, n_moving=6)
    batch = dict(
        xyz=np.stack([f["pos1"] for f in frames]).astype(np.float32),
        flow=np.stack([f["gt"] for f in frames]).astype(np.float32),
        labels=np.stack([f["s_fg_mask"] > 0.5 for f in frames]).astype(
            np.int32),
        mask=np.stack([f["mask1"] for f in frames]).astype(np.float32))
    noise = (0.03 * np.random.default_rng(11).normal(
        size=batch["flow"].shape)).astype(np.float32)
    return batch, noise


def _label_weights(batch) -> np.ndarray:
    from ssf_slam_tpu_torch.data.carla import compute_label_weights

    return compute_label_weights([
        dict(s_fg_mask=batch["labels"][i].astype(np.float32),
             mask1=batch["mask"][i]) for i in range(len(batch["xyz"]))])


def make_fixture(path: str = TRAIN_REF) -> None:
    """The JAX script's train step (its ``train_step`` with the noise
    given instead of drawn) on ``_batch``: loss, gradient norms, new batch
    statistics and parameters after ``optax.adam``."""
    import jax
    import jax.numpy as jnp
    import optax

    from ssf_slam_tpu.models.segnet import SegNet

    batch, noise = _batch()
    lw = _label_weights(batch)
    model = SegNet(n_classes=2, **SMALL_TRAIN_SEG)
    variables = jax.tree.map(jnp.asarray,
                             torch_ref.load_npz_variables(SEG_NPZ))
    params, batch_stats = variables["params"], variables["batch_stats"]
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    class_w = jnp.asarray(lw, jnp.float32)
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def step(params, opt_state):
        flow_in = b["flow"] + jnp.asarray(noise)

        def loss_fn(params):
            logits, updates = model.apply(
                {"params": params, "batch_stats": batch_stats},
                b["xyz"], flow_in, train=True, mutable=["batch_stats"])
            logits = logits.astype(jnp.float32)
            labels = b["labels"]
            ll = jax.nn.log_softmax(logits, axis=-1)
            ce = -jnp.take_along_axis(ll, labels[..., None], -1)[..., 0]
            w = class_w[labels] * b["mask"]
            return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0), updates

        (loss, updates), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        upd, opt_state = tx.update(grads, opt_state, params)
        return (loss, grads, updates["batch_stats"],
                optax.apply_updates(params, upd))

    loss, grads, stats, new_params = step(params, opt_state)
    grads = torch_ref.flatten({"params": grads})
    np.savez(path, loss=np.float32(loss), label_weights=lw,
             **{f"grad/{k}": v for k, v in grads.items()},
             **torch_ref.flatten({"batch_stats": stats}),
             **{f"new_{k}": v for k, v in torch_ref.flatten(
                 {"params": new_params}).items()})
    print(f"wrote {path}: loss {float(loss):.6f}, {len(grads)} leaves")


def _port_small(device="cpu"):
    from ssf_slam_tpu_torch.models.segnet import SegNet
    from ssf_slam_tpu_torch.weights import from_flax, load_npz

    model = SegNet(n_classes=2, **SMALL_TRAIN_SEG)
    model.load_state_dict(from_flax(load_npz(SEG_NPZ)), strict=True)
    return model.to(device)


@pytest.fixture(scope="module")
def port_step():
    return _port_step()


def _port_step():
    """The port's step on the same batch and noise: (loss, flat gradients,
    new batch statistics, parameters after Adam), and the JAX fixture."""
    from ssf_slam_tpu_torch.train.train_segnet import weighted_ce
    from ssf_slam_tpu_torch.train.trainer import Adam
    from ssf_slam_tpu_torch.weights import to_flax

    with np.load(TRAIN_REF) as z:
        want = {k: z[k] for k in z.files}
    batch, noise = _batch()
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    t["labels"] = t["labels"].long()
    model = _port_small().train()
    params = dict(model.named_parameters())
    logits = model(t["xyz"], t["flow"] + torch.from_numpy(noise))
    loss = weighted_ce(logits, t["labels"], t["mask"],
                       torch.from_numpy(want["label_weights"]))
    grads = torch.autograd.grad(loss, list(params.values()))
    flat_grads = to_flax(model, dict(zip(params, grads)))
    tx = Adam(LR)
    state = tx.init(params)
    tx.update(dict(zip(params, grads)), state, params)
    after = to_flax(model)
    return float(loss.detach()), flat_grads, after, want


def _jax_grads(want: dict) -> dict:
    return {k[len("grad/"):]: v for k, v in want.items()
            if k.startswith("grad/")}


def test_segnet_train_step_matches_jax(port_step):
    loss, grads, after, want = port_step
    assert loss == pytest.approx(float(want["loss"]), rel=LOSS_RTOL)
    jgrads = _jax_grads(want)
    assert grads.keys() == jgrads.keys() and len(jgrads) > 40
    for k, w in jgrads.items():
        norm = np.linalg.norm(w)
        assert np.linalg.norm(grads[k]) == pytest.approx(norm,
                                                         rel=GRAD_RTOL), k
        # and element by element, within GRAD_RTOL of the leaf's norm
        assert np.abs(grads[k] - w).max() <= GRAD_RTOL * norm, k


def test_segnet_train_step_batch_stats_match_jax(port_step):
    _, _, after, want = port_step
    stats = {k for k in want if k.startswith("batch_stats/")}
    assert stats == {k for k in after if k.startswith("batch_stats/")}
    for k in stats:
        np.testing.assert_allclose(after[k], want[k], atol=STATS_TOL,
                                   rtol=STATS_TOL, err_msg=k)


def test_segnet_train_step_adam_params_match_jax(port_step):
    """Adam's first step is lr g / (|g| + 1e-8): about lr sign(g). Where
    |g| lies below the two packages' gradient rounding (a few 1e-9 here)
    the sign, and so the step, is set by rounding (a few dozen of the
    95,330 elements move by up to 2 lr). So the port's Adam is held on
    JAX's own gradient within 1e-6, and the port's whole step within
    PARAM_TOL wherever |g| >= ADAM_G_FLOOR (1e-6, 100 eps: there an error
    of 1e-8 in g moves the step by at most lr 1e-8 eps / g^2 = 1e-13)."""
    from ssf_slam_tpu_torch.train.trainer import Adam
    from ssf_slam_tpu_torch.weights import load_npz

    _, _, after, want = port_step
    before = load_npz(SEG_NPZ)
    jgrads = _jax_grads(want)
    new = {k[len("new_"):]: v for k, v in want.items()
           if k.startswith("new_")}
    assert new.keys() == {k for k in after if k.startswith("params/")}
    params = {k: torch.from_numpy(before[k].copy()) for k in new}
    tx = Adam(LR)
    tx.update({k: torch.from_numpy(jgrads[k]) for k in new},
              tx.init(params), params)
    held = total = 0
    for k, v in new.items():
        np.testing.assert_allclose(params[k].numpy(), v, atol=1e-6, rtol=0,
                                   err_msg=f"Adam on JAX's gradient: {k}")
        sure = np.abs(jgrads[k]) >= ADAM_G_FLOOR
        np.testing.assert_allclose(after[k][sure], v[sure], atol=PARAM_TOL,
                                   rtol=0, err_msg=k)
        held, total = held + sure.sum(), total + sure.size
    assert held >= 0.95 * total, (held, total)


def test_adam_matches_optax():
    import jax.numpy as jnp
    import optax

    from ssf_slam_tpu_torch.train.trainer import Adam

    rng = np.random.default_rng(2)
    shapes = {"a": (16, 8), "b": (8,), "c": (3, 5, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tx = optax.adam(LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    opt = Adam(LR)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = opt.init(tp)
    for step in range(3):
        g = {k: (rng.normal(size=s) * 10.0 ** -step).astype(np.float32)
             for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step} {k}")
    assert tstate.count == 3


def test_eval_metrics_match_jax_eval_step():
    import jax
    import jax.numpy as jnp

    from ssf_slam_tpu.models.segnet import SegNet
    from ssf_slam_tpu_torch.train.train_segnet import eval_metrics

    batch, _ = _batch()
    # a noise level at which the classifier errs on some points
    noise = (0.3 * np.random.default_rng(3).normal(
        size=batch["flow"].shape)).astype(np.float32)
    model = SegNet(n_classes=2, **SMALL_TRAIN_SEG)
    variables = jax.tree.map(jnp.asarray,
                             torch_ref.load_npz_variables(SEG_NPZ))
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    # scripts/train_segnet.py::eval_step with the noise given
    logits = model.apply(variables, b["xyz"], b["flow"] + noise, train=False)
    pred = jnp.argmax(logits.astype(jnp.float32), axis=-1)
    m, y = b["mask"], b["labels"]

    def iou(p, t):
        inter = jnp.sum((p & t) & (m > 0))
        union = jnp.sum((p | t) & (m > 0))
        return inter / jnp.maximum(union, 1)

    want = dict(iou_moving=iou(pred == 1, y == 1),
                iou_static=iou(pred == 0, y == 0),
                acc=jnp.sum((pred == y) * m) / jnp.maximum(jnp.sum(m), 1.0))
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    t["labels"] = t["labels"].long()
    got = eval_metrics(_port_small(), t, torch.from_numpy(noise))
    assert got.keys() == want.keys()
    for k in want:
        assert float(got[k]) == float(want[k]), k
    assert 0 < float(got["iou_moving"]) < 1 and float(got["acc"]) < 1


def test_train_segnet_script_writes_best(tmp_path, monkeypatch):
    from ssf_slam_tpu_torch.train import train_segnet
    from ssf_slam_tpu_torch.weights import load_segnet

    monkeypatch.setattr(train_segnet, "N_POINTS", 1024)
    out = tmp_path / "run"
    assert train_segnet.main(["--epochs", "1", "--n-worlds", "1",
                              "--frames-per-world", "2", "--batch-size",
                              "2", "--out", str(out), "--device",
                              "cpu"]) == 0
    lines = (out / "metrics.jsonl").read_text().splitlines()
    rec = json.loads(lines[0])
    assert len(lines) == 1 and rec["step"] == 0
    assert {"epoch_loss", "iou_moving", "iou_static", "acc"} <= rec.keys()
    assert np.isfinite(rec["epoch_loss"])
    assert json.loads((out / "config.json").read_text())["n_points"] == 1024
    model = load_segnet(str(out / "best.npz"), device="cpu")
    with torch.inference_mode():
        xyz = torch.randn(1, 1024, 3) * 10
        assert model(xyz, torch.zeros_like(xyz)).shape == (1, 1024, 2)


if __name__ == "__main__":
    if sys.argv[1:] != ["--make-fixture"]:
        sys.exit("usage: python tests/test_torch_segnet_train.py "
                 "--make-fixture")
    import jax

    jax.config.update("jax_platforms", "cpu")
    make_fixture()
