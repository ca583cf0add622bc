"""Masked softmax over local entities.

Numerical contract matches the reference (reasongnn.py:130-131, 168-169):
``softmax(score + (1 - mask) * VERY_NEG_NUMBER)`` along the entity axis,
always in float32.
"""

import torch

VERY_NEG_NUMBER = -1e11  # reference: reasongnn.py:9 (-100000000000)


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    scores = scores.float() + (1.0 - mask.float()) * VERY_NEG_NUMBER
    return torch.softmax(scores, dim=dim)
