"""Fixed-iteration Gaussian-mixture EM (ssf_slam_tpu/ops/gmm.py).

The background/foreground split of the NO_SEG and SF variants: a
two-component full-covariance GMM over [flow || xyz], the majority cluster
taken as background. As in the JAX package: a deterministic init (the
masked mean, then farthest-point seeds), a fixed iteration count, the
``reg_covar`` floor added both in the M-step and before each Cholesky, and
the majority-cluster pick. Every step stays on the device: the Cholesky
reports failure in its info tensor (``cholesky_ex``) instead of a host
check, and the seeds are picked by a tensor index.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def _log_gaussian(x: Tensor, mean: Tensor, chol: Tensor) -> Tensor:
    """log N(x; mean, L L^T) for x [N, D], mean [K, D], lower chol
    [K, D, D] -> [K, N]."""
    d = x.shape[-1]
    diff = (x[None] - mean[:, None]).transpose(-1, -2)  # [K, D, N]
    y = torch.linalg.solve_triangular(chol, diff, upper=False)
    maha = torch.sum(y * y, dim=-2)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2,
                                                      dim2=-1)), dim=-1)
    return -0.5 * (maha + logdet[:, None] + d * math.log(2.0 * math.pi))


def gmm_em(x: Tensor, mask: Tensor | None = None, n_components: int = 2,
           n_iters: int = 25, reg_covar: float = 1e-6):
    """Full-covariance EM over x [N, D]; ``mask`` [N] bool excludes rows
    from the fit (they are still assigned). Returns (labels [N] int32,
    resp [N, K], means [K, D], weights [K])."""
    n, d = x.shape
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=x.device)
    w_valid = mask.to(x.dtype)
    n_valid = torch.clamp(torch.sum(w_valid), min=1.0)

    # component 0 at the masked mean, the others by farthest-point seeding
    med = torch.sum(x * w_valid[:, None], dim=0) / n_valid
    seeds = [med]
    neg_inf = torch.full_like(w_valid, -math.inf)
    dist = torch.where(mask, torch.sum((x - med) ** 2, dim=-1), neg_inf)
    for _ in range(n_components - 1):
        far = x.index_select(0, torch.argmax(dist).reshape(1))[0]
        seeds.append(far)
        dist = torch.minimum(dist, torch.where(
            mask, torch.sum((x - far) ** 2, dim=-1), neg_inf))
    means = torch.stack(seeds)  # [K, D]

    var0 = torch.sum(((x - med) ** 2) * w_valid[:, None], dim=0) / n_valid
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    cov = torch.diag(var0 + reg_covar)[None].repeat(n_components, 1, 1)
    weights = torch.full((n_components,), 1.0 / n_components,
                         dtype=x.dtype, device=x.device)

    def e_step(means, cov, weights):
        chol = torch.linalg.cholesky_ex(cov + reg_covar * eye[None])[0]
        log_p = _log_gaussian(x, means, chol).T  # [N, K]
        log_p = log_p + torch.log(torch.clamp(weights, min=1e-12))
        return torch.exp(log_p - torch.logsumexp(log_p, dim=-1,
                                                 keepdim=True))

    def m_step(resp):
        r = resp * w_valid[:, None]  # [N, K]
        nk = torch.clamp(torch.sum(r, dim=0), min=1e-8)
        means = (r.T @ x) / nk[:, None]
        diff = x[None] - means[:, None]  # [K, N, D]
        cov = torch.einsum("kn,knd,kne->kde", r.T, diff, diff) \
            / nk[:, None, None]
        return means, cov + reg_covar * eye[None], nk / n_valid

    for _ in range(n_iters):
        means, cov, weights = m_step(e_step(means, cov, weights))
    resp = e_step(means, cov, weights)
    labels = torch.argmax(resp, dim=-1).to(torch.int32)
    return labels, resp, means, weights


def gmm_background_mask(features: Tensor, mask: Tensor | None = None,
                        n_iters: int = 25) -> Tensor:
    """[N, D] features -> [N] bool background mask: the more populated of
    two GMM clusters (scripts/PointCloudOdometry_noSeg.py:97-103)."""
    labels = gmm_em(features, mask=mask, n_components=2, n_iters=n_iters)[0]
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.bool,
                          device=labels.device)
    count1 = torch.sum(torch.where(mask, labels, torch.zeros_like(labels)))
    n_valid = torch.sum(mask)
    bg_label = (count1 * 2 > n_valid).to(labels.dtype)
    return (labels == bg_label) & mask
