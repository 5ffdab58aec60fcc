"""Dual-softmax patch attention and the fused cost-attention chain
(ssf_slam_tpu/ops/attention.py).

``attention_xla`` and ``cost_attention_xla`` are the JAX package's XLA
references in plain PyTorch. ``attention_fused`` is the port of the Pallas
kernel ``_attention_pallas_2d``: the dual-softmax attention alone, with the
product kept in float32 and one rounding of each attended output
(``csrc/attention.cu`` for CUDA tensors, ``attention_plain`` for CPU
tensors); its gradient re-linearises ``attention_xla``, as the JAX custom
VJP does. ``cost_attention_fused`` is the port of the
Pallas kernel ``_cost_attention_2d``: per query point, the dual-softmax
attention of its K-neighbour patch, the BN-folded 3-layer weightnet on the
attended q' and k', and the softmax-over-K aggregation of ``q_cost``. It
has two versions behind one wrapper:
- a CUDA kernel (``csrc/cost_attention.cu``) for CUDA tensors;
- ``cost_attention_plain``, the same numerics in plain PyTorch, taken only
  for CPU tensors. A CUDA tensor launches the kernel or raises.
Both compute what the Pallas body computes, which differs from
``cost_attention_xla`` in where it rounds to the feature type: the
dual-softmax product and the attended features are rounded to it.

``LAUNCHES`` counts kernel launches; the plain versions do not count.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

LAUNCHES = {"attention": 0, "cost_attention": 0}
BN_EPS = 1e-3  # the weightnet BatchNorms' epsilon (Flax), not PyTorch's


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def attention_xla(q_feat: Tensor, k_feat: Tensor) -> tuple[Tensor, Tensor]:
    """[.., N, K, C] pair -> attended pair. The products accumulate in
    float32 (``preferred_element_type``) and are cast back on the add."""
    q32, k32 = q_feat.float(), k_feat.float()
    w = torch.matmul(q32, k32.transpose(-1, -2))  # [.., K, K]
    w = torch.softmax(w, dim=-2) * torch.softmax(w, dim=-1)
    q_att = q_feat + torch.matmul(w, k32).to(q_feat.dtype)
    k_att = k_feat + torch.matmul(w.transpose(-1, -2), q32).to(k_feat.dtype)
    return q_att, k_att


def attention_plain(q_feat: Tensor, k_feat: Tensor) -> tuple[Tensor, Tensor]:
    """The Pallas body of ``_attention_pallas_2d`` in plain PyTorch
    ([.., N, K, C]): inputs to float32; W = QK^T, dual softmax over the
    q-row axis (-2) and the k-column axis (-1), the product kept in float32;
    q' = q + W k and k' = k + W^T q summed in float32 and rounded once to
    each input's type (``attention_xla`` rounds the products first)."""
    q32, k32 = q_feat.float(), k_feat.float()
    w = torch.matmul(q32, k32.transpose(-1, -2))
    e1 = torch.exp(w - torch.amax(w, dim=-2, keepdim=True))
    s1 = e1 / torch.sum(e1, dim=-2, keepdim=True)
    e2 = torch.exp(w - torch.amax(w, dim=-1, keepdim=True))
    s2 = e2 / torch.sum(e2, dim=-1, keepdim=True)
    w = s1 * s2
    qa = (q32 + torch.matmul(w, k32)).to(q_feat.dtype)
    ka = (k32 + torch.matmul(w.transpose(-1, -2), q32)).to(k_feat.dtype)
    return qa, ka


def _attention_kernel(q_feat: Tensor, k_feat: Tensor) -> tuple[Tensor, Tensor]:
    """CUDA tensors launch ``csrc/attention.cu``; CPU tensors take
    ``attention_plain``."""
    devs = {q_feat.device, k_feat.device}
    if devs == {torch.device("cpu")}:
        return attention_plain(q_feat, k_feat)
    if len(devs) != 1 or q_feat.device.type != "cuda":
        raise ValueError(f"tensors on several or unsupported devices: {devs}")
    dt = q_feat.dtype
    if dt not in (torch.float32, torch.bfloat16) or k_feat.dtype != dt:
        raise TypeError(f"feature types {dt}, {k_feat.dtype} (one of "
                        f"float32, bfloat16)")
    *_, k, c = q_feat.shape
    if k_feat.shape != q_feat.shape or not 1 <= k <= MAX_K \
            or not 1 <= c <= 512:
        raise ValueError("attention: inconsistent shapes")
    from ssf_slam_tpu_torch.ops import cuda_build

    q_feat, k_feat = q_feat.contiguous(), k_feat.contiguous()
    qa, ka = torch.empty_like(q_feat), torch.empty_like(k_feat)
    cuda_build.call(
        "ssf_attention", "ssf_attention", q_feat.data_ptr(), k_feat.data_ptr(),
        q_feat.numel() // (k * c), k, c, int(dt == torch.bfloat16),
        qa.data_ptr(), ka.data_ptr(), torch.cuda.current_stream().cuda_stream)
    LAUNCHES["attention"] += 1
    return qa, ka


class _AttentionFused(torch.autograd.Function):
    """The kernel forward; the backward re-linearises ``attention_xla`` at
    the saved inputs (attention.py::_attention_fused_bwd)."""

    @staticmethod
    def forward(ctx, q_feat, k_feat):
        ctx.save_for_backward(q_feat, k_feat)
        return _attention_kernel(q_feat, k_feat)

    @staticmethod
    def backward(ctx, g_q, g_k):
        q_feat, k_feat = ctx.saved_tensors
        with torch.enable_grad():
            q = q_feat.detach().requires_grad_()
            k = k_feat.detach().requires_grad_()
            outs = attention_xla(q, k)
            cts = [torch.zeros_like(o) if g is None else g
                   for o, g in zip(outs, (g_q, g_k))]
            return torch.autograd.grad(outs, (q, k), cts)


def attention_fused(q_feat: Tensor, k_feat: Tensor) -> tuple[Tensor, Tensor]:
    """The fused dual-softmax attention ([.., N, K, C] pair -> attended
    pair), differentiable in both inputs."""
    return _AttentionFused.apply(q_feat, k_feat)


def fold_weightnet(params: dict, batch_stats: dict,
                   eps: float = BN_EPS) -> tuple:
    """Fold the inference BatchNorms into the weightnet's Dense weights.

    ``params`` / ``batch_stats`` hold the Flax-layout entries Dense_0,
    BatchNorm_0, Dense_1, BatchNorm_1, Dense_2 ({"kernel" [in, out],
    "bias"}, {"scale", "bias"}, {"mean", "var"}). Returns
    (W1 [C, C], b1 [C], W2 [C, C/2], b2 [C/2], W3 [C/2, 1], b3 [1]) with
    ``scale * (x W - mean) / sqrt(var + eps) + bias`` rewritten as
    ``x (W f) + (bias - mean f)``, f = scale / sqrt(var + eps)."""

    def fold(dense, bn, stats):
        f = bn["scale"] / torch.sqrt(stats["var"] + eps)
        return dense["kernel"] * f[None, :], bn["bias"] - stats["mean"] * f

    w1, b1 = fold(params["Dense_0"], params["BatchNorm_0"],
                  batch_stats["BatchNorm_0"])
    w2, b2 = fold(params["Dense_1"], params["BatchNorm_1"],
                  batch_stats["BatchNorm_1"])
    return (w1, b1, w2, b2, params["Dense_2"]["kernel"],
            params["Dense_2"]["bias"])


def folded_weightnet(wn: tuple):
    """The folded weightnet (W1, b1, W2, b2, W3, b3) as a function of the
    attended features [.., K, C] -> float32 logits [.., K]. Its products
    run in the feature type, accumulating in float32, as the Dense stack it
    replaces."""
    w1, b1, w2, b2, w3, b3 = wn

    def weightnet(x: Tensor) -> Tensor:
        dt = x.dtype
        h = torch.relu(torch.matmul(x, w1.to(dt)).float() + b1).to(dt)
        h = torch.relu(torch.matmul(h, w2.to(dt)).float() + b2).to(dt)
        return (torch.matmul(h, w3.to(dt)).float() + b3)[..., 0]

    return weightnet


def cost_attention_xla(q_feat: Tensor, k_feat: Tensor, q_cost: Tensor,
                       weightnet) -> tuple[Tensor, Tensor]:
    """The XLA chain ([.., N, K, C] inputs): (cost_fwd [.., N, C] in
    q_cost's type, w_k logits [.., N, K]). ``weightnet`` maps attended
    features to logits [.., N, K]: ``folded_weightnet`` of the folded
    weights (the JAX package's ``cost_attention_xla``), or the cost
    volume's own layers on its unfused branch. The softmax over K and the
    weighted sum run in the logits' type."""
    q_att, k_att = attention_xla(q_feat, k_feat)
    w_q, w_k = weightnet(q_att), weightnet(k_att)
    weights1 = torch.softmax(w_q, dim=-1)[..., None]
    cost_fwd = torch.sum(weights1 * q_cost.to(weights1.dtype), dim=-2)
    return cost_fwd.to(q_cost.dtype), w_k


def _mm32(a: Tensor, b: Tensor) -> Tensor:
    """a @ b of feature-type operands with float32 accumulation: the
    operands are exact in float32, so a float32 product is that."""
    return torch.matmul(a.float(), b.float())


def cost_attention_plain(q_feat: Tensor, k_feat: Tensor, q_cost: Tensor,
                         wn: tuple) -> tuple[Tensor, Tensor]:
    """The Pallas kernel body's numerics in plain PyTorch ([.., N, K, C]):
    W = QK^T (float32); dual softmax over the q-row axis (-2) and the
    k-column axis (-1), product rounded to the feature type; q' = q + W k
    and k' = k + W^T q summed in float32 and rounded; the weightnet with
    weights cast to the feature type, hidden layers rounded after bias and
    ReLU, float32 logits; softmax over K of w_q weighting q_cost in float32,
    cast to q_cost's type. Returns (cost_fwd [.., N, C], w_k [.., N, K]
    float32)."""
    dt = q_feat.dtype
    w1, b1, w2, b2, w3, b3 = wn
    w = _mm32(q_feat, k_feat.transpose(-1, -2))
    e1 = torch.exp(w - torch.amax(w, dim=-2, keepdim=True))
    s1 = e1 / torch.sum(e1, dim=-2, keepdim=True)
    e2 = torch.exp(w - torch.amax(w, dim=-1, keepdim=True))
    s2 = e2 / torch.sum(e2, dim=-1, keepdim=True)
    w = (s1 * s2).to(dt)
    qa = (q_feat.float() + _mm32(w, k_feat)).to(dt)
    ka = (k_feat.float() + _mm32(w.transpose(-1, -2), q_feat)).to(dt)

    def weightnet(x):
        h = torch.clamp(_mm32(x, w1.to(dt)) + b1, min=0.0).to(dt)
        h = torch.clamp(_mm32(h, w2.to(dt)) + b2, min=0.0).to(dt)
        return (_mm32(h, w3.to(dt)) + b3)[..., 0]

    wq, wk = weightnet(qa), weightnet(ka)
    ew = torch.exp(wq - torch.amax(wq, dim=-1, keepdim=True))
    wt = ew / torch.sum(ew, dim=-1, keepdim=True)
    cf = torch.sum(wt[..., None] * q_cost.float(), dim=-2)
    return cf.to(q_cost.dtype), wk.float()


MAX_K, MAX_C = 32, 128


def cost_attention_fused(q_feat: Tensor, k_feat: Tensor, q_cost: Tensor,
                         wn: tuple) -> tuple[Tensor, Tensor]:
    """The fused chain: (cost_fwd [.., N, C], w_k logits [.., N, K]).
    CUDA tensors launch ``csrc/cost_attention.cu``; CPU tensors take
    ``cost_attention_plain``."""
    tensors = (q_feat, k_feat, q_cost, *wn)
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return cost_attention_plain(q_feat, k_feat, q_cost, wn)
    if devs != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on several or unsupported devices: "
                         f"{ {t.device for t in tensors} }")
    w1, b1, w2, b2, w3, b3 = wn
    *lead, n, k, c = q_feat.shape
    c2 = w2.shape[-1]
    dt = q_feat.dtype
    if dt not in (torch.float32, torch.bfloat16) or k_feat.dtype != dt \
            or q_cost.dtype != dt:
        raise TypeError(f"feature types {dt}, {k_feat.dtype}, "
                        f"{q_cost.dtype} (one of float32, bfloat16)")
    if (k_feat.shape != q_feat.shape or q_cost.shape != q_feat.shape
            or w1.shape != (c, c) or b1.shape != (c,)
            or w2.shape != (c, c2) or b2.shape != (c2,)
            or w3.shape != (c2, 1) or b3.shape != (1,)
            or not 1 <= k <= MAX_K or not 1 <= c <= MAX_C
            or not 1 <= c2 <= MAX_C):
        raise ValueError("cost attention: inconsistent shapes")
    from ssf_slam_tpu_torch.ops import cuda_build

    rows = q_feat.numel() // (k * c)
    q_feat, k_feat, q_cost = (t.contiguous() for t in (q_feat, k_feat,
                                                       q_cost))
    wts = [t.float().contiguous() for t in wn]
    cf = torch.empty(*lead, n, c, dtype=q_cost.dtype, device=q_feat.device)
    wk = torch.empty(*lead, n, k, dtype=torch.float32, device=q_feat.device)
    cuda_build.call(
        "ssf_cost_attention", "ssf_cost_attention", q_feat.data_ptr(),
        k_feat.data_ptr(), q_cost.data_ptr(), *(t.data_ptr() for t in wts),
        rows, k, c, c2, int(dt == torch.bfloat16), cf.data_ptr(),
        wk.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    LAUNCHES["cost_attention"] += 1
    return cf, wk
