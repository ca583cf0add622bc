"""Weight bridge between flax parameter trees and the port's state_dicts.

``from_flax`` maps every leaf of a flax tree (``{"params": {...}}`` or the
inner dict, numpy or jax arrays) to the port's parameter of the same path.
The module's own name decides the rule:

* ``Dense`` (``question_emb``, ``attn_linear``, ``question_linear{i}``,
  ``cq_linear``, ``ca_linear``, fusion ``r``/``g``, ``score_func``,
  ``e2e_linear{s}``, ``attn_out_{i}``, ``ffn1_{i}``, ``ffn2_{i}``,
  ``entity_linear``, ``relation_linear``, ``relation_linear_inv_proj``,
  ``relation_linear1``, GraftNet's ``kb_{self,head,tail}_linear{s}``,
  ``q2e_linear{s}``, ``e2q_linear{s}``): kernel ``[in, out]`` ->
  ``nn.Linear.weight`` ``[out, in]``;
* ``DenseGeneral`` (``q_{i}``, ``k_{i}``, ``v_{i}``): kernel ``[hidden,
  heads, head_dim]`` -> ``[hidden, hidden]`` linear, bias ``[heads,
  head_dim]`` -> ``[hidden]``;
* ``Embed`` (``tok_emb``, ``pos_emb``, ReaRev's ``pos_emb{s}`` and
  ``pos_emb_inv{s}``, ``word_embedding``, ``relation_embedding[_inv]``):
  ``embedding`` -> ``weight``;
* ``LayerNorm`` (``emb_ln``, ``ln1_{i}``, ``ln2_{i}``): ``scale`` ->
  ``weight``;
* ``OptimizedLSTMCell`` (``OptimizedLSTMCell_0`` of the LSTM question
  encoder): the input kernels ``{ii,if,ig,io}`` ``[in, D]`` (no bias) ->
  ``lstm.weight_ih_l0`` ``[4D, in]``, the recurrent kernels ``{hi,hf,hg,ho}``
  ``[D, D]`` -> ``lstm.weight_hh_l0`` and their biases -> ``lstm.bias_hh_l0``,
  in torch's gate order i, f, g, o;
* ``self.param`` leaves (``rel_linear{s}``, ``kb_self_linear``, their
  ``_bias``, ``type_emb``) keep their layout.

NSM's teacher (``reasoning_back``) has the submodule names of its forward
reasoning, so the same rules carry it.

A leaf that no rule names raises ``KeyError``; loading the result with
``load_state_dict`` (strict) catches parameters left unfilled. ``to_flax``
is the inverse.

``llama_from_flax`` / ``llama_to_flax`` do the same for the LLM reader
(``llm.model.LlamaLM``). Its TDense kernels are already ``[out, in]``
(gnn_rag_tpu/llm_tpu/model.py:111-136), so they map onto
``nn.Linear.weight`` with no transpose; ``tok_emb.embedding`` maps onto the
embedding's ``weight`` and the RMSNorm ``scale``s keep their name
(``lm_head`` is absent when the embeddings are tied). An int8 tree
(``quant.quantize_params``) carries ``kernel_q`` ``[in, out]`` int8, which
becomes ``QuantLinear.weight_q`` ``[out, in]``, and its ``scale``.
``lora_from_flax`` carries a JAX adapter dict (``lora.init_lora``) across.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_KINDS = (
    ("raw", re.compile(r"rel_linear\d+(_bias)?|kb_self_linear(_bias)?|type_emb")),
    ("dense_general", re.compile(r"[qkv]_\d+")),
    ("dense", re.compile(r"question_emb|attn_linear|question_linear\d+|cq_linear|"
                         r"ca_linear|r|g|score_func|e2e_linear\d+|attn_out_\d+|"
                         r"ffn[12]_\d+|entity_linear|relation_linear|"
                         r"relation_linear_inv_proj|relation_linear1|"
                         r"kb_(self|head|tail)_linear\d+|q2e_linear\d+|"
                         r"e2q_linear\d+")),
    ("embed", re.compile(r"tok_emb|pos_emb(_inv)?\d*|word_embedding|"
                         r"relation_embedding(_inv)?")),
    ("layer_norm", re.compile(r"emb_ln|ln[12]_\d+")),
)
_LEAVES = {  # kind -> {flax leaf: torch leaf}
    "dense": {"kernel": "weight", "bias": "bias"},
    "dense_general": {"kernel": "weight", "bias": "bias"},
    "embed": {"embedding": "weight"},
    "layer_norm": {"scale": "weight", "bias": "bias"},
}


_LSTM_CELL = "OptimizedLSTMCell_0"
_LSTM_GATES = "ifgo"   # torch's order of the four gates
_LSTM_LEAVES = {"weight_ih_l0": ("i", "kernel"), "weight_hh_l0": ("h", "kernel"),
                "bias_hh_l0": ("h", "bias")}


def _kind(name: str) -> str:
    for kind, pat in _KINDS:
        if pat.fullmatch(name):
            return kind
    return ""


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if hasattr(v, "items"):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v, np.float32)


def from_flax(params) -> Dict[str, torch.Tensor]:
    """flax parameter tree -> the port's state_dict (float32 CPU tensors)."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    cells: Dict[str, Dict[str, np.ndarray]] = {}
    for path, arr in _flatten(params):
        module, _, leaf = path.rpartition(".")
        owner, _, gate = module.rpartition(".")
        if owner.rpartition(".")[2] == _LSTM_CELL:
            cells.setdefault(owner.rpartition(".")[0], {})[f"{gate}.{leaf}"] = arr
            continue
        if _kind(leaf) == "raw":
            name, val = path, arr
        else:
            kind = _kind(module.rpartition(".")[2])
            tleaf = _LEAVES.get(kind, {}).get(leaf)
            if tleaf is None:
                raise KeyError(f"bridge: no rule for flax leaf {path!r} {arr.shape}")
            name = f"{module}.{tleaf}"
            if kind == "dense_general":
                val = arr.reshape(arr.shape[0], -1).T if leaf == "kernel" else arr.reshape(-1)
            elif kind == "dense" and leaf == "kernel":
                val = arr.T
            else:
                val = arr
        out[name] = torch.from_numpy(np.array(val, np.float32))  # a writable copy
    for prefix, leaves in cells.items():
        for tleaf, (kind, fleaf) in _LSTM_LEAVES.items():
            parts = [leaves[f"{kind}{g}.{fleaf}"] for g in _LSTM_GATES]
            val = np.concatenate([p.T for p in parts] if fleaf == "kernel" else parts)
            out[_join(prefix, "lstm", tleaf)] = torch.from_numpy(
                np.array(val, np.float32))
    return out


def to_flax(state_dict, heads: int = 0) -> dict:
    """The port's state_dict -> ``{"params": tree}`` of numpy arrays.
    ``heads``: attention heads of a transformer encoder in the dict (its
    q/k/v linears become DenseGeneral kernels)."""
    tree: dict = {}
    for name, t in state_dict.items():
        arr = t.detach().float().cpu().numpy()
        module, _, leaf = name.rpartition(".")
        if leaf in _LSTM_LEAVES and module.rpartition(".")[2] == "lstm":
            kind, fleaf = _LSTM_LEAVES[leaf]
            cell = _join(module.rpartition(".")[0], _LSTM_CELL)
            for g, part in zip(_LSTM_GATES, np.split(arr, 4)):
                _put(tree, _join(cell, f"{kind}{g}", fleaf),
                     part.T if fleaf == "kernel" else part)
            continue
        if _kind(leaf) == "raw":
            path, val = name, arr
        else:
            kind = _kind(module.rpartition(".")[2])
            fleaf = {v: k for k, v in _LEAVES.get(kind, {}).items()}.get(leaf)
            if fleaf is None:
                raise KeyError(f"bridge: no rule for torch parameter {name!r}")
            path, val = f"{module}.{fleaf}", arr
            if kind == "dense_general":
                if heads <= 0:
                    raise ValueError(f"bridge: {name} needs the head count")
                hd = arr.shape[0] // heads
                val = (arr.T.reshape(arr.shape[1], heads, hd) if leaf == "weight"
                       else arr.reshape(heads, hd))
            elif kind == "dense" and leaf == "weight":
                val = arr.T
        _put(tree, path, val)
    return {"params": tree}


def _join(*parts: str) -> str:
    return ".".join(p for p in parts if p)


def _put(tree: dict, path: str, val) -> None:
    node = tree
    *parents, last = path.split(".")
    for p in parents:
        node = node.setdefault(p, {})
    node[last] = np.ascontiguousarray(val)


_LLAMA_LEAVES = {"kernel": "weight", "embedding": "weight", "scale": "scale"}


def llama_from_flax(params) -> Dict[str, torch.Tensor]:
    """flax LlamaLM parameter tree -> ``LlamaLM`` state_dict (float32 CPU
    tensors, no transposes)."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        module, _, leaf = path.rpartition(".")
        if leaf == "kernel_q":
            out[f"{module}.weight_q"] = torch.from_numpy(
                np.ascontiguousarray(arr.T).astype(np.int8))
            continue
        if leaf not in _LLAMA_LEAVES:
            raise KeyError(f"bridge: no rule for flax leaf {path!r} {arr.shape}")
        out[f"{module}.{_LLAMA_LEAVES[leaf]}"] = torch.from_numpy(
            np.array(arr, np.float32))
    return out


def lora_from_flax(lora) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX adapters ``{"['params']['layer_0']...['kernel']": {"a", "b"}}``
    -> the port's ``{"layer_0....weight": {"a", "b"}}`` (float32 CPU
    tensors; A ``[in, r]`` and B ``[r, out]`` in both)."""
    out = {}
    for key, ab in lora.items():
        parts = [p for p in re.findall(r"\['([^']*)'\]", key) if p != "params"]
        if not parts or parts[-1] != "kernel":
            raise KeyError(f"bridge: no rule for flax adapter {key!r}")
        out[".".join(parts[:-1] + ["weight"])] = {
            k: torch.from_numpy(np.array(v, np.float32)) for k, v in ab.items()}
    return out


def llama_to_flax(state_dict) -> dict:
    """``LlamaLM`` state_dict -> ``{"params": tree}`` of numpy arrays."""
    tree: dict = {}
    for name, t in state_dict.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "scale":
            fleaf = "scale"
        elif leaf == "weight":
            fleaf = "embedding" if module == "tok_emb" else "kernel"
        else:
            raise KeyError(f"bridge: no rule for torch parameter {name!r}")
        node = tree
        for part in module.split("."):
            node = node.setdefault(part, {})
        node[fleaf] = np.ascontiguousarray(t.detach().float().cpu().numpy())
    return {"params": tree}
