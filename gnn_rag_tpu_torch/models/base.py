"""Loss functions and Hit@1 of the GNN models (reference: gnn/models/
base_model.py:187-199, 287-292, rearev.py:227-233, nsm.py:142-149), ported
from ``gnn_rag_tpu.models.base``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def kl_loss_vec(pred_dist: torch.Tensor, answer_dist: torch.Tensor) -> torch.Tensor:
    """Elementwise KL(answer_prob || pred) with answer-count normalisation
    (base_model.py:193-199). Returns [B, E]; 0*log0 := 0."""
    answer_len = answer_dist.sum(dim=1, keepdim=True)
    answer_len = torch.where(answer_len == 0, torch.ones_like(answer_len),
                             answer_len)
    answer_prob = answer_dist / answer_len
    log_pred = torch.log(pred_dist + 1e-8)
    pos = answer_prob > 0
    safe_log_ans = torch.log(torch.where(pos, answer_prob,
                                         torch.ones_like(answer_prob)))
    return torch.where(pos, answer_prob * (safe_log_ans - log_pred),
                       torch.zeros_like(answer_prob))


def bce_loss_vec(pred_logits: torch.Tensor, answer_dist: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits against 0.9-smoothed binary labels (base_model.py:187-191)."""
    labels = (answer_dist > 0).to(pred_logits.dtype) * 0.9
    return -(labels * F.logsigmoid(pred_logits)
             + (1.0 - labels) * F.logsigmoid(-pred_logits))


def masked_mean_loss(loss_vec: torch.Tensor, case_valid: torch.Tensor) -> torch.Tensor:
    """sum(loss * valid) / B (rearev.py:156-160)."""
    return (loss_vec * case_valid).sum() / loss_vec.shape[0]


def calc_loss_label(pred: torch.Tensor, answer_dist: torch.Tensor,
                    loss_type: str = "kl") -> torch.Tensor:
    """Full loss with no-answer filtering (rearev.py:227-233)."""
    case_valid = (answer_dist.sum(dim=1, keepdim=True) > 0).to(pred.dtype)
    vec = (kl_loss_vec(pred, answer_dist) if loss_type == "kl"
           else bce_loss_vec(pred, answer_dist))
    return masked_mean_loss(vec, case_valid)


def js_div_vec(dist_1: torch.Tensor, dist_2: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon divergence terms (nsm.py:142-149), elementwise [B, E];
    0*log0 := 0."""
    log_mean = torch.log((dist_1 + dist_2) / 2 + 1e-8)

    def kld(target):
        pos = target > 0
        safe_log_t = torch.log(torch.where(pos, target, torch.ones_like(target)))
        return torch.where(pos, target * (safe_log_t - log_mean),
                           torch.zeros_like(target))

    return 0.5 * (kld(dist_1) + kld(dist_2))


VERY_SMALL_NUMBER = 1e-10


def calc_h1(pred_dist: torch.Tensor, answer_dist: torch.Tensor,
            eps: float = VERY_SMALL_NUMBER) -> torch.Tensor:
    """Hit@1 per sample on the device (base_model.py:287-292): 1.0 where the
    top-1 entity (the first one on ties) is an answer."""
    top1 = torch.argmax(pred_dist, dim=-1)
    is_ans = torch.gather((answer_dist > eps).float(), 1, top1[:, None])[:, 0]
    return (is_ans > 0).float()
