"""Global (yaw, dx, dy) initialisation by bird's-eye-view occupancy
correlation (ssf_slam_tpu/odometry/bev_init.py).

The non-ground points of both scans are rasterised into binary occupancy
grids (``half_extent`` / ``cell``: 512 x 512 at the defaults), one for each
of ``n_yaw`` yaw candidates of the current scan, and cross-correlated with
the last scan's grid by FFT; the argmax within ``max_shift`` (with a
parabolic sub-cell refinement) seeds the ONLY_PC Gauss-Newton. With a
constant-velocity prediction ``pred_t`` and ``plaus_gate`` > 0, a peak
inside the dynamics window wins over an implausible global argmax that
scores not much higher (a building-period alias). The yaw candidates are a
leading dimension: all grids are built by one ``index_add_`` and
correlated by one batched ``rfft2`` / ``irfft2`` (cuFFT on the card). Every
pick is a select or a gather on device tensors: no host sync.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor


def _take(x: Tensor, i: Tensor) -> Tensor:
    """x[i] along dim 0 for a 0-d index tensor, as a gather."""
    return x.index_select(0, i.reshape(1))[0]


def _yaw_candidates(span: float, num: int, device) -> Tensor:
    """The float32 values of ``jnp.linspace(-span, span, num)`` as XLA
    compiles it in the JAX package's ``bev_pose_init``: (-span) (1 - i r) +
    i (span r), r = 1 / (num - 1), each operation rounded to float32, then
    ``span`` itself (``torch.linspace`` rounds the inner values
    otherwise)."""
    r = float(np.float32(1.0) / np.float32(num - 1))
    step = float(np.float32(span) * np.float32(r))
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    out = -span * (1.0 - i * r) + i * step
    return torch.cat([out, torch.full((1,), span, device=device)])


def _grids(xyz: Tensor, mask: Tensor, cell: float, half_extent: float,
           ground_z: float, n_bins: int) -> Tensor:
    """Binary occupancy [B, n_bins, n_bins] of xyz [B, N, 3]: the points
    above ``ground_z`` in the grid, counted by one ``index_add_`` and
    clamped at 1 (exact: the counts are whole numbers)."""
    b = xyz.shape[0]
    keep = mask & (xyz[..., 2] > ground_z)
    ij = torch.floor((xyz[..., :2] + half_extent) / cell).to(torch.int64)
    inb = keep & torch.all((ij >= 0) & (ij < n_bins), dim=-1)
    ij = torch.clamp(ij, 0, n_bins - 1)
    batch = torch.arange(b, device=xyz.device)[:, None]
    flat = (batch * n_bins + ij[..., 0]) * n_bins + ij[..., 1]
    g = torch.zeros(b * n_bins * n_bins, dtype=torch.float32,
                    device=xyz.device)
    g.index_add_(0, flat.reshape(-1), inb.to(torch.float32).reshape(-1))
    return torch.clamp(g, max=1.0).reshape(b, n_bins, n_bins)


def _peak(corr: Tensor, cell: float, window: Tensor | None = None):
    """Per batch row of corr [B, n, n]: the argmax (within ``window``)
    with a 1-D parabolic sub-cell refinement on each axis. Returns (t [B,
    3], score [B], whether the cell is a local maximum of the whole
    surface [B])."""
    b, n_bins = corr.shape[0], corr.shape[-1]
    flat_corr = corr.reshape(b, -1)
    c = flat_corr if window is None else torch.where(
        window.reshape(1, -1), flat_corr, -math.inf)
    flat = torch.argmax(c, dim=-1)
    si, sj = flat // n_bins, flat % n_bins

    def at(i, j):
        pos = (i % n_bins) * n_bins + j % n_bins
        return torch.gather(flat_corr, 1, pos[:, None])[:, 0]

    c0 = at(si, sj)
    nb = torch.stack([at(si - 1, sj), at(si + 1, sj), at(si, sj - 1),
                      at(si, sj + 1)])
    nb = torch.where(torch.isfinite(nb), nb, c0[None])
    is_local_max = c0 >= torch.amax(nb, dim=0)

    def parab(cm, c0, cp):
        denom = cm - 2.0 * c0 + cp
        off = torch.where(torch.abs(denom) > 1e-6, 0.5 * (cm - cp) / denom,
                          torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    half = n_bins // 2
    dx = (torch.where(si > half, si - n_bins, si) + parab(nb[0], c0, nb[1])
          ) * cell
    dy = (torch.where(sj > half, sj - n_bins, sj) + parab(nb[2], c0, nb[3])
          ) * cell
    t = torch.stack([dx, dy, torch.zeros_like(dx)], dim=-1)
    return t, c0, is_local_max


def _correlation(curr_xyz, curr_mask, last_xyz, last_mask, cell,
                 half_extent, max_shift, ground_z) -> Tensor:
    """Circular cross-correlation corr[s] = sum_x g_last[x] g_curr[x - s]
    of each copy curr_xyz [B, N, 3] with the last scan's grid, -inf past
    ``max_shift`` (the wrap-around aliases): [B, n_bins, n_bins]."""
    n_bins = int(2 * half_extent / cell)
    g_curr = _grids(curr_xyz, curr_mask, cell, half_extent, ground_z, n_bins)
    g_last = _grids(last_xyz[None], last_mask, cell, half_extent, ground_z,
                    n_bins)
    corr = torch.fft.irfft2(torch.fft.rfft2(g_last)
                            * torch.conj(torch.fft.rfft2(g_curr)),
                            s=(n_bins, n_bins))
    k = int(max_shift / cell)
    idx = torch.arange(n_bins, device=corr.device)
    ring = torch.minimum(idx, n_bins - idx)
    ok = (ring[:, None] <= k) & (ring[None, :] <= k)
    return torch.where(ok, corr, -math.inf)


def _correlate(curr_xyz, curr_mask, last_xyz, last_mask, cell, half_extent,
               max_shift, ground_z, pred_t=None, plaus_gate=0.0):
    """Correlation of each rotated copy curr_xyz [Y, N, 3] with the last
    scan: (t_global [Y, 3], score_global [Y]), and with ``pred_t`` the
    windowed peak too (t, score, whether it is a genuine local max)."""
    corr = _correlation(curr_xyz, curr_mask, last_xyz, last_mask, cell,
                        half_extent, max_shift, ground_z)
    t_g, s_g, _ = _peak(corr, cell)
    if pred_t is None or plaus_gate <= 0.0:
        return t_g, s_g
    # the plausibility window: shifts within plaus_gate of the prediction
    n_bins = corr.shape[-1]
    idx = torch.arange(n_bins, device=corr.device)
    disp = torch.where(idx > n_bins // 2, idx - n_bins, idx) * cell
    d2 = ((disp[:, None] - pred_t[0]) ** 2
          + (disp[None, :] - pred_t[1]) ** 2)
    window = d2 <= plaus_gate * plaus_gate
    t_p, s_p, p_localmax = _peak(corr, cell, window=window)
    # no finite cell in the window: the windowed peak is an artefact
    nonempty = torch.any((window[None] & torch.isfinite(corr)).reshape(
        corr.shape[0], -1), dim=-1)
    return t_g, s_g, t_p, s_p, p_localmax & nonempty & torch.isfinite(s_p)


def bev_pose_init(curr_xyz: Tensor, curr_mask: Tensor, last_xyz: Tensor,
                  last_mask: Tensor, yaw_span: float = 0.1, n_yaw: int = 11,
                  cell: float = 0.25, half_extent: float = 64.0,
                  max_shift: float = 8.0, ground_z: float = -1.2,
                  pred_t: Tensor | None = None, plaus_gate: float = 0.0,
                  plaus_rel: float = 0.85) -> tuple[Tensor, Tensor]:
    """Joint (yaw, dx, dy) init over ``n_yaw`` yaw candidates in
    [-yaw_span, yaw_span]. curr_xyz [N, 3] carries the warm-start rotation;
    returns (the residual yaw about z, 0-d; t [3]). With ``pred_t`` and
    ``plaus_gate`` > 0: when a velocity exists (|pred_t| > 0.05 m) and the
    global argmax lies farther than ``plaus_gate`` from the prediction,
    the best plausible candidate (a yaw's global peak inside the window,
    else its windowed peak if that is a local max) wins if it scores at
    least ``plaus_rel`` of the global one."""
    dev = curr_xyz.device
    yaws = _yaw_candidates(yaw_span, n_yaw, dev)
    c, s = torch.cos(yaws)[:, None], torch.sin(yaws)[:, None]
    x, y = curr_xyz[None, :, 0], curr_xyz[None, :, 1]
    rot = torch.stack([x * c - y * s, x * s + y * c,
                       curr_xyz[None, :, 2].expand(n_yaw, -1)], dim=-1)
    windowed = pred_t is not None and plaus_gate > 0.0
    out = _correlate(rot, curr_mask, last_xyz, last_mask, cell, half_extent,
                     max_shift, ground_z,
                     pred_t=pred_t if windowed else None,
                     plaus_gate=plaus_gate)
    if not windowed:
        t_g, s_g = out
        best = torch.argmax(s_g)
        return _take(yaws, best), _take(t_g, best)
    t_g, s_g, t_p, s_p, p_lm = out
    best_g = torch.argmax(s_g)
    dev_g = torch.linalg.norm(t_g[:, :2] - pred_t[None, :2], dim=-1)
    in_gate = dev_g <= plaus_gate
    plaus_ok = in_gate | p_lm
    t_pl = torch.where(in_gate[:, None], t_g, t_p)
    s_pl = torch.where(in_gate, s_g, torch.where(p_lm, s_p, -math.inf))
    best_p = torch.argmax(s_pl)
    s_best_p = _take(s_pl, best_p)
    have_vel = torch.linalg.norm(pred_t[:2]) > 0.05
    use_plaus = (have_vel & (_take(dev_g, best_g) > plaus_gate)
                 & torch.any(plaus_ok)
                 & (s_best_p >= plaus_rel * _take(s_g, best_g))
                 & torch.isfinite(s_best_p))
    pick = torch.where(use_plaus, best_p, best_g)
    t = torch.where(use_plaus, _take(t_pl, pick), _take(t_g, pick))
    return _take(yaws, pick), t


def bev_translation_init(curr_xyz: Tensor, curr_mask: Tensor,
                         last_xyz: Tensor, last_mask: Tensor,
                         cell: float = 0.5, half_extent: float = 64.0,
                         max_shift: float = 8.0,
                         ground_z: float = -1.2) -> Tensor:
    """[dx, dy, 0] shifting the (already rotated) current points onto the
    last ones: the correlation's argmax within ``max_shift``, no sub-cell
    refinement."""
    corr = _correlation(curr_xyz[None], curr_mask, last_xyz, last_mask,
                        cell, half_extent, max_shift, ground_z)[0]
    n_bins = corr.shape[-1]
    flat = torch.argmax(corr)
    si, sj = flat // n_bins, flat % n_bins
    half = n_bins // 2
    dx = torch.where(si > half, si - n_bins, si).to(torch.float32) * cell
    dy = torch.where(sj > half, sj - n_bins, sj).to(torch.float32) * cell
    return torch.stack([dx, dy, torch.zeros_like(dx)])
