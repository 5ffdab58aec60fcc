"""Closed-form eigendecomposition of symmetric 3x3 matrices
(ssf_slam_tpu/ops/eig3.py), carried over formula for formula: the
trigonometric solution of the characteristic cubic in the mean-shifted
form, and the eigenvector of the smallest eigenvalue as the largest column
of the Cayley-Hamilton annihilator ``(A - l_mid I)(A - l_hi I)``.
``torch.linalg.eigh`` would pick other signs and orders of eigenvectors.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def eigvals_sym3(a: Tensor) -> Tensor:
    """Eigenvalues of symmetric [..., 3, 3] matrices, ascending."""
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / 3.0
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    safe_p = torch.clamp(p, min=1e-20)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    b = (a - q[..., None, None] * eye) / safe_p[..., None, None]
    b00, b11, b22 = b[..., 0, 0], b[..., 1, 1], b[..., 2, 2]
    b01, b02, b12 = b[..., 0, 1], b[..., 0, 2], b[..., 1, 2]
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def smallest_eigvec_sym3(a: Tensor) -> tuple[Tensor, Tensor]:
    """(eigenvalues ascending [..., 3], unit eigenvector [..., 3] of the
    smallest eigenvalue); e_z for a scalar matrix."""
    evals = eigvals_sym3(a)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m = torch.matmul(a - evals[..., 1, None, None] * eye,
                     a - evals[..., 2, None, None] * eye)
    norms = torch.sum(m * m, dim=-2)  # column squared norms
    col = torch.argmax(norms, dim=-1)
    v = torch.gather(m, -1, col[..., None, None].expand(
        *m.shape[:-1], 1))[..., 0]
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    ez = eye[2]
    return evals, torch.where(n > 1e-12, v / torch.clamp(n, min=1e-20), ez)
