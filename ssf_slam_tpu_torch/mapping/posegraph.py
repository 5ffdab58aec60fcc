"""Batch Gauss-Newton pose-graph optimisation
(ssf_slam_tpu/mapping/posegraph.py), run when a loop closes.

Factors: between factors on consecutive keyframes (the odometry-measured
relative pose, information 1/var per rotation and translation axis) and
loop between factors with a scalar weight; node 0 and the absent nodes are
held by a 1e12 diagonal (the gauge), the others get 1e-6.

Linearisation: the JAX package takes ``jax.jacfwd`` of all residuals over
all K*6 right-perturbation deltas. A residual depends on the deltas of its
two nodes only, so here each factor's two 6x6 blocks come from
``torch.func.jacfwd`` of the same residual function, and the blocks are
placed into the dense Jacobian; the normal equations and the dense solve
are the JAX package's. Factors of weight 0 (odometry row 0, inactive
nodes, unused loop slots) contribute nothing, and their blocks are zeroed
so that no degenerate linearisation point can reach the solve.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from ssf_slam_tpu_torch.ops.se3 import (
    pose_between,
    quat_conjugate,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    so3_exp_quat,
    so3_log_quat,
)

Tensor = torch.Tensor


def retract(q: Tensor, t: Tensor, delta: Tensor) -> tuple[Tensor, Tensor]:
    """Right-perturbation retraction T' = T o (Exp(dw), dt)."""
    q2 = quat_normalize(quat_multiply(q, so3_exp_quat(delta[..., :3])))
    return q2, t + quat_rotate(q, delta[..., 3:])


def between_residual(qa, ta, qb, tb, mq, mt) -> Tensor:
    """e = Log(m^-1 o (T_a^-1 o T_b)) in R^6 (rotation, then translation)."""
    rq, rt = pose_between((qa, ta), (qb, tb))
    mqc = quat_conjugate(mq)
    return torch.cat([so3_log_quat(quat_multiply(mqc, rq)),
                      quat_rotate(mqc, rt - mt)], dim=-1)


def _factor_residual(da, db, qa, ta, qb, tb, mq, mt):
    qa2, ta2 = retract(qa, ta, da)
    qb2, tb2 = retract(qb, tb, db)
    return between_residual(qa2, ta2, qb2, tb2, mq, mt)


_factor_jac = vmap(jacfwd(_factor_residual, argnums=(0, 1)))


def solve_pose_graph(q: Tensor, t: Tensor, active: Tensor,
                     odom_rel_q: Tensor, odom_rel_t: Tensor, loop_a: Tensor,
                     loop_b: Tensor, loop_rel_q: Tensor, loop_rel_t: Tensor,
                     loop_w: Tensor, odom_w_rot: float = 1e6,
                     odom_w_trans: float = 1e4,
                     iters: int = 8) -> tuple[Tensor, Tensor]:
    """q [K, 4], t [K, 3], active [K] bool, odometry factors (i-1 -> i;
    row 0 unused), loop factors a -> b with weights [L] (0 = unused) ->
    optimised (q, t). Node 0 is the gauge."""
    k = q.shape[0]
    dev, dt = q.device, q.dtype
    node = torch.arange(k, device=dev)
    odom_on = (active & (node > 0)).to(dt)
    w_odom = torch.stack([torch.full((k,), odom_w_rot, dtype=dt, device=dev)]
                         * 3 + [torch.full((k,), odom_w_trans, dtype=dt,
                                           device=dev)] * 3,
                         dim=-1) * odom_on[:, None]  # [K, 6]
    w_loop = loop_w[:, None].expand(-1, 6)
    # factor f joins nodes a[f] -> b[f]: odometry rows (i-1, i) with row 0
    # wrapping to (K-1, 0) as the JAX roll does, then the loop factors (a
    # loop node past the buffer is its last node, as XLA clamps the gather)
    fa = torch.cat([torch.roll(node, 1), loop_a.long().clamp(max=k - 1)])
    fb = torch.cat([node, loop_b.long().clamp(max=k - 1)])
    mq = torch.cat([odom_rel_q, loop_rel_q])
    mt = torch.cat([odom_rel_t, loop_rel_t])
    wf = torch.cat([w_odom, w_loop])  # [F, 6]
    n_f = fa.shape[0]
    on = (wf > 0).any(-1)[:, None, None]
    frozen = (node == 0) | ~active
    diag = torch.where(frozen, 1e12, 1e-6).to(dt).repeat_interleave(6)
    rows = torch.arange(n_f * 6, device=dev)
    zero6 = torch.zeros(n_f, 6, dtype=dt, device=dev)
    for _ in range(iters):
        qa, ta, qb, tb = q[fa], t[fa], q[fb], t[fb]
        r = between_residual(qa, ta, qb, tb, mq, mt)  # [F, 6]
        # torch.func's forward mode takes no inference tensors and, in
        # PyTorch 2.11, has no batching rule for _make_dual under
        # inference_mode (the sequence runners' mode): linearise on normal
        # copies outside it
        with torch.inference_mode(False):
            ja, jb = _factor_jac(*(x.clone() for x in (
                zero6, zero6, qa, ta, qb, tb, mq, mt)))
        # (some of torch's forward-mode formulas return float64 tangents)
        ja = torch.where(on, ja.to(dt), 0.0)
        jb = torch.where(on, jb.to(dt), 0.0)
        jac = torch.zeros(n_f * 6, k * 6, dtype=dt, device=dev)
        cols = torch.arange(6, device=dev)
        ca = (fa[:, None] * 6 + cols).repeat_interleave(6, 0)  # [F*6, 6]
        cb = (fb[:, None] * 6 + cols).repeat_interleave(6, 0)
        jac.index_put_((rows[:, None].expand(-1, 6), ca),
                       ja.reshape(-1, 6), accumulate=True)
        jac.index_put_((rows[:, None].expand(-1, 6), cb),
                       jb.reshape(-1, 6), accumulate=True)
        w = wf.reshape(-1)
        h = (jac * w[:, None]).T @ jac + torch.diag(diag)
        g = jac.T @ (torch.where(on[:, :, 0], r, 0.0) * wf).reshape(-1)
        delta = -torch.linalg.solve(h, g).reshape(k, 6)
        q, t = retract(q, t, delta)
    return q, t
