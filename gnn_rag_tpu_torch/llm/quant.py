"""Weight-only int8 for the LLM reader's serving path, the port of
gnn_rag_tpu/llm_tpu/quant.py.

Symmetric per-output-channel scales: a projection weight W ``[out, in]``
(``TLinear``'s layout, one contiguous row per output) is held as
``W_q * scale[:, None]``, W_q int8 and ``scale = max|W| / 127`` per output
row (1 where the row is all zero), rounded half to even and clipped to
±127. The scale commutes with the contraction, so the product runs on the
int8 weight and the scale multiplies the float32 result:
``x @ W.T ~ (x @ W_q.T) * scale``.

``QuantLinear`` computes that in the model's compute type, as
``QuantDenseGeneral`` does: x and W_q cast to it, the product, then
``(y.float() * scale).to(dtype)``. The JAX package leaves the int8 -> bf16
convert to XLA's fusion; here ``weight_q.to(dtype)`` writes a dequantized
copy on every call (1 byte read, 2 written, 2 read by the GEMM a weight,
where a fused int8 GEMV would read 1).

Usage::

    model_q = LlamaLM(dataclasses.replace(cfg, quant="int8"))
    model_q.load_state_dict(quantize_state_dict(model.state_dict()))
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# the modules whose weight is quantized: every projection the decode GEMV
# streams; the token embedding (a per-token gather) and the norms stay
QUANT_KERNELS = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj", "lm_head")


class QuantLinear(nn.Module):
    """Bias-free projection over an int8 weight: buffers ``weight_q`` int8
    ``[out, in]`` and ``scale`` float32 ``[out]``; computes in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = dtype
        self.register_buffer("weight_q", torch.zeros(out_features, in_features,
                                                     dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))

    def forward(self, x):
        y = F.linear(x.to(self.compute_dtype), self.weight_q.to(self.compute_dtype))
        return (y.float() * self.scale).to(self.compute_dtype)


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[out, in]`` weight -> (int8 ``[out, in]``, float32 scale ``[out]``)."""
    w2 = w.float()
    amax = w2.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w2 / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A full-precision ``LlamaLM`` state_dict -> the ``quant="int8"``
    model's: every ``QUANT_KERNELS`` module's ``weight`` becomes
    ``weight_q`` and ``scale`` (on the weight's device); every other entry
    passes through."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "weight" and module.rpartition(".")[2] in QUANT_KERNELS:
            out[f"{module}.weight_q"], out[f"{module}.scale"] = quantize_kernel(t)
        else:
            out[name] = t
    return out


def param_bytes(state: Mapping[str, torch.Tensor]) -> int:
    """Bytes of every tensor of a state_dict."""
    return sum(t.numel() * t.element_size() for t in state.values())
