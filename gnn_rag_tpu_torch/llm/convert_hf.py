"""Import a local HF LLaMA checkpoint into the port's ``LlamaLM``, the port of
gnn_rag_tpu/llm_tpu/convert_hf.py ``load_hf_llama``.

The JAX package loads the checkpoint through ``transformers`` and renames
its tensors into a flax tree; the port reads the directory itself
(``utils.hf_import.read_state_dict``: ``model.safetensors`` or
``pytorch_model.bin``, whole or sharded, and ``config.json``) and renames
the tensors onto ``LlamaLM``'s state_dict. ``TLinear`` keeps HF's ``[out,
in]`` weights, so nothing is transposed, and the model splits heads on the
activations, so nothing is reshaped.

    state_dict, cfg = load_hf_llama("path/to/llama-2-7b-hf")
    model = LlamaLM(cfg); model.load_state_dict(state_dict)
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import torch

from ..utils.hf_import import read_state_dict
from .model import LlamaConfig

# HF LlamaForCausalLM name (after "model.layers.<i>.") -> LlamaLM name
# (after "layer_<i>.")
_LAYER_NAMES = {
    "input_layernorm.weight": "input_norm.scale",
    "post_attention_layernorm.weight": "post_attn_norm.scale",
    "self_attn.q_proj.weight": "attn.q_proj.weight",
    "self_attn.k_proj.weight": "attn.k_proj.weight",
    "self_attn.v_proj.weight": "attn.v_proj.weight",
    "self_attn.o_proj.weight": "attn.o_proj.weight",
    "mlp.gate_proj.weight": "mlp.gate_proj.weight",
    "mlp.up_proj.weight": "mlp.up_proj.weight",
    "mlp.down_proj.weight": "mlp.down_proj.weight",
}


def load_hf_llama(model_path: str) -> Tuple[Dict[str, torch.Tensor], LlamaConfig]:
    """(``LlamaLM`` state_dict of float32 CPU tensors, ``LlamaConfig``) of
    the HF LLaMA checkpoint directory ``model_path``."""
    with open(os.path.join(model_path, "config.json")) as f:
        c = json.load(f)
    # the fields gnn_rag_tpu/llm_tpu/convert_hf.py reads, with its defaults
    cfg = LlamaConfig(
        vocab_size=c["vocab_size"], dim=c["hidden_size"],
        n_layers=c["num_hidden_layers"], n_heads=c["num_attention_heads"],
        n_kv_heads=c.get("num_key_value_heads") or c["num_attention_heads"],
        intermediate=c["intermediate_size"],
        rope_theta=c.get("rope_theta", 10000.0),
        max_seq_len=c["max_position_embeddings"], norm_eps=c["rms_norm_eps"])
    hf = read_state_dict(model_path)
    sd = {"tok_emb.weight": hf["model.embed_tokens.weight"],
          "final_norm.scale": hf["model.norm.weight"],
          # a tied checkpoint saves no lm_head (transformers ties it back)
          "lm_head.weight": hf.get("lm_head.weight",
                                   hf["model.embed_tokens.weight"])}
    for i in range(cfg.n_layers):
        for hf_name, name in _LAYER_NAMES.items():
            sd[f"layer_{i}.{name}"] = hf[f"model.layers.{i}.{hf_name}"]
    return {k: v.float().contiguous() for k, v in sd.items()}, cfg
