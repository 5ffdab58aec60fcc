"""The cost volume's dual-softmax patch attention and its weighted
aggregation in plain PyTorch (``attention_xla``, ``cost_attention_xla``),
the unfused chain that the served configuration runs."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def attention_xla(q_feat: Tensor, k_feat: Tensor) -> tuple[Tensor, Tensor]:
    """[.., N, K, C] pair -> attended pair. The products accumulate in
    float32 (``preferred_element_type``) and are cast back on the add."""
    q32, k32 = q_feat.float(), k_feat.float()
    w = torch.matmul(q32, k32.transpose(-1, -2))  # [.., K, K]
    w = torch.softmax(w, dim=-2) * torch.softmax(w, dim=-1)
    q_att = q_feat + torch.matmul(w, k32).to(q_feat.dtype)
    k_att = k_feat + torch.matmul(w.transpose(-1, -2), q32).to(k_feat.dtype)
    return q_att, k_att


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
