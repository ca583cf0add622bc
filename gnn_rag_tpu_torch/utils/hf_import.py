"""Load a local HuggingFace encoder checkpoint into the port's frozen-LM
modules, without ``transformers``.

Port of ``gnn_rag_tpu.utils.hf_import`` (``HF_MODEL_NAMES``,
``load_hf_encoder`` and its bert, roberta, t5 and mpnet maps). The JAX
package loads the checkpoint through ``transformers.AutoModel`` and
transposes it into flax trees; the port reads the files itself and maps
them straight onto the ``state_dict`` of ``models.encoders.
TransformerQuestionEncoder`` (bert, roberta and the BERT-layout simcse and
relbert), ``models.encoder_variants.T5Encoder`` (t5) or ``MPNetEncoder``
(sbert2), whose linears keep HF's ``[out, in]`` weights:

* ``config.json`` with ``json``;
* ``model.safetensors`` by its header (an 8-byte little-endian length, a
  JSON table of names to dtype, shape and data offsets, then the raw
  bytes), or ``pytorch_model.bin`` with ``torch.load(weights_only=True)``,
  each also as shards listed in its ``*.index.json``.

A registry key or name resolves as ``huggingface_hub.try_to_load_from_cache``
does: a local directory first, then the hub cache's
``models--<org>--<name>/snapshots/<refs/main>/`` under ``HF_HUB_CACHE``,
else ``$HF_HOME/hub``, else ``~/.cache/huggingface/hub``. Nothing is
downloaded: a checkpoint in neither place raises ``FileNotFoundError``
(``models.frozen_lm.maybe_frozen_lm`` then falls back loudly).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import torch

HF_MODEL_NAMES = {
    "bert": "bert-base-uncased",
    "roberta": "roberta-base",
    "sbert": "sentence-transformers/all-MiniLM-L6-v2",
    "sbert2": "sentence-transformers/all-mpnet-base-v2",
    "simcse": "princeton-nlp/sup-simcse-bert-base-uncased",
    "relbert": "pretrained_lms/sr-simbert/",
}

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def hub_cache() -> str:
    """The hub cache directory ``huggingface_hub`` reads."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.environ.get("HF_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache", "huggingface")
    return os.path.join(home, "hub")


def resolve(name: str) -> str:
    """The local directory of checkpoint ``name``: ``name`` itself when it
    is a directory, else its snapshot of ``main`` in the hub cache."""
    if os.path.isdir(name):
        return name
    repo = os.path.join(hub_cache(), "models--" + name.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            snap = os.path.join(repo, "snapshots", f.read().strip())
        if os.path.isfile(os.path.join(snap, "config.json")):
            return snap
    raise FileNotFoundError(
        f"{name} is not a local directory and not in the HF cache "
        f"({hub_cache()})")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, read by its header."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // dtype.itemsize
        flat = (torch.frombuffer(data, dtype=dtype, count=count,
                                 offset=8 + n + begin).clone()
                if count else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The weights of checkpoint directory ``path``: safetensors first,
    then ``pytorch_model.bin``, either whole or as indexed shards."""
    for stem, reader in (("model.safetensors", read_safetensors),
                         ("pytorch_model.bin", lambda p: torch.load(
                             p, map_location="cpu", weights_only=True))):
        whole = os.path.join(path, stem)
        if os.path.isfile(whole):
            return reader(whole)
        index = whole + ".index.json"
        if os.path.isfile(index):
            with open(index) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            sd = {}
            for shard in shards:
                sd.update(reader(os.path.join(path, shard)))
            return sd
    raise FileNotFoundError(f"{path}: no model.safetensors or "
                            f"pytorch_model.bin")


def _base_model_keys(sd: dict, prefix: str) -> dict:
    """The base model's weights as ``AutoModel`` loads them: a task
    checkpoint's ``<prefix>.`` stripped, old LayerNorm ``gamma``/``beta``
    names renamed."""
    if not any(k.startswith("embeddings.") or k.startswith("encoder.")
               for k in sd):
        sd = {k[len(prefix) + 1:]: v for k, v in sd.items()
              if k.startswith(prefix + ".")}
    return {k.replace("LayerNorm.gamma", "LayerNorm.weight")
             .replace("LayerNorm.beta", "LayerNorm.bias"): v
            for k, v in sd.items()}


def load_hf_encoder(lm: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """``lm`` is a registry key (sbert/bert/...) or a checkpoint name or
    path -> (float32 ``state_dict`` of the matching port module, dims)."""
    path = resolve(HF_MODEL_NAMES.get(lm, lm))
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    arch = cfg.get("model_type", "bert")
    sd = {k: v.float() if v.is_floating_point() else v
          for k, v in read_state_dict(path).items()}
    if arch == "t5":
        return _map_t5(sd, cfg)
    if arch == "mpnet":
        return _map_mpnet(_base_model_keys(sd, "mpnet"), cfg)
    # bert / roberta / simcse / relbert share the BERT layout
    sd = _base_model_keys(sd, "roberta" if arch == "roberta" else "bert")
    dims = {"hidden": cfg["hidden_size"], "vocab": cfg["vocab_size"],
            "layers": cfg["num_hidden_layers"],
            "heads": cfg["num_attention_heads"],
            "intermediate": cfg["intermediate_size"],
            "max_len": cfg["max_position_embeddings"],
            "arch": "roberta" if arch == "roberta" else "bert",
            "pad_idx": cfg.get("pad_token_id", 0) or 0}
    p = {"tok_emb.weight": sd["embeddings.word_embeddings.weight"],
         "pos_emb.weight": sd["embeddings.position_embeddings.weight"],
         "type_emb": sd["embeddings.token_type_embeddings.weight"][0],
         "emb_ln.weight": sd["embeddings.LayerNorm.weight"],
         "emb_ln.bias": sd["embeddings.LayerNorm.bias"]}
    names = {"q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value", "attn_out": "attention.output.dense",
             "ln1": "attention.output.LayerNorm", "ffn1": "intermediate.dense",
             "ffn2": "output.dense", "ln2": "output.LayerNorm"}
    for i in range(dims["layers"]):
        for ours, theirs in names.items():
            for part in ("weight", "bias"):
                p[f"{ours}_{i}.{part}"] = sd[f"encoder.layer.{i}.{theirs}.{part}"]
    return p, dims


def _map_t5(sd, cfg) -> Tuple[dict, dict]:
    """T5 encoder stack -> ``T5Encoder`` (the reference's t5 variant runs
    AutoModel('t5-small').encoder, bert_encoder.py:52-55, 95-98)."""
    dims = {"hidden": cfg["d_model"], "vocab": cfg["vocab_size"],
            "layers": cfg["num_layers"], "heads": cfg["num_heads"],
            "intermediate": cfg["d_ff"], "head_dim": cfg["d_kv"],
            "num_buckets": cfg["relative_attention_num_buckets"],
            "max_distance": cfg.get("relative_attention_max_distance", 128),
            "eps": cfg["layer_norm_epsilon"], "arch": "t5"}
    emb = "shared.weight" if "shared.weight" in sd else "encoder.embed_tokens.weight"
    p = {"tok_emb.weight": sd[emb],
         "rel_bias.weight": sd["encoder.block.0.layer.0.SelfAttention."
                               "relative_attention_bias.weight"],
         "final_ln.scale": sd["encoder.final_layer_norm.weight"]}
    for i in range(dims["layers"]):
        pre = f"encoder.block.{i}."
        att = pre + "layer.0.SelfAttention."
        for name in ("q", "k", "v", "o"):
            p[f"{name}_{i}.weight"] = sd[att + f"{name}.weight"]
        p[f"ln_attn_{i}.scale"] = sd[pre + "layer.0.layer_norm.weight"]
        p[f"wi_{i}.weight"] = sd[pre + "layer.1.DenseReluDense.wi.weight"]
        p[f"wo_{i}.weight"] = sd[pre + "layer.1.DenseReluDense.wo.weight"]
        p[f"ln_ffn_{i}.scale"] = sd[pre + "layer.1.layer_norm.weight"]
    return p, dims


def _map_mpnet(sd, cfg) -> Tuple[dict, dict]:
    """MPNetModel -> ``MPNetEncoder`` (the reference's sbert2 =
    all-mpnet-base-v2, bert_encoder.py:46-50)."""
    dims = {"hidden": cfg["hidden_size"], "vocab": cfg["vocab_size"],
            "layers": cfg["num_hidden_layers"],
            "heads": cfg["num_attention_heads"],
            "intermediate": cfg["intermediate_size"],
            "max_len": cfg["max_position_embeddings"],
            "num_buckets": cfg.get("relative_attention_num_buckets", 32),
            "eps": cfg.get("layer_norm_eps", 1e-12),
            "pad_idx": cfg.get("pad_token_id", 1), "arch": "mpnet"}
    p = {"tok_emb.weight": sd["embeddings.word_embeddings.weight"],
         "pos_emb.weight": sd["embeddings.position_embeddings.weight"],
         "emb_ln.weight": sd["embeddings.LayerNorm.weight"],
         "emb_ln.bias": sd["embeddings.LayerNorm.bias"],
         "rel_bias.weight": sd["encoder.relative_attention_bias.weight"]}
    names = {"q": "attention.attn.q", "k": "attention.attn.k",
             "v": "attention.attn.v", "attn_out": "attention.attn.o",
             "ln1": "attention.LayerNorm", "ffn1": "intermediate.dense",
             "ffn2": "output.dense", "ln2": "output.LayerNorm"}
    for i in range(dims["layers"]):
        for ours, theirs in names.items():
            for part in ("weight", "bias"):
                p[f"{ours}_{i}.{part}"] = sd[f"encoder.layer.{i}.{theirs}.{part}"]
    return p, dims
