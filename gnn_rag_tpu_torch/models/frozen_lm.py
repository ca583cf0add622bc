"""Frozen question/relation LM encoding outside the model forward.

Port of ``gnn_rag_tpu.models.frozen_lm.FrozenLM.encode`` and of the frozen-LM
part of ``gnn_rag_tpu.cli.assemble`` (cli.py:216-236): the frozen encoder
runs once over relation surface forms and questions, and the model consumes
the hidden states (reference: bert_encoder.py:89-109 with lm_frozen=1,
base_model.py:168-176).

Weight sources, in order of preference (``maybe_frozen_lm``, the port of
frozen_lm.py:45-115):
1. a local HuggingFace checkpoint (``FrozenLM.from_hf``: ``utils.hf_import``
   reads it without ``transformers`` into the matching module: bert,
   roberta, t5 or mpnet);
2. a deterministic random init (MiniLM widths), chosen LOUDLY: a warning,
   and ``weight_source`` records the exception's type and text.
A ``state_dict`` (e.g. ``bridge.from_flax`` of the JAX encoder's params) can
also be given directly.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from .encoders import TransformerQuestionEncoder, flax_like_init_


class FrozenLM:
    def __init__(self, word_dim: int = 384, vocab_size: int = 30522,
                 layers: int = 6, heads: int = 12,
                 intermediate: Optional[int] = None, max_len: int = 512,
                 seed: int = 0, state_dict=None, module=None, device="cuda"):
        self.device = torch.device(device)
        self.module = module or TransformerQuestionEncoder(
            vocab_size=vocab_size, hidden=word_dim, layers=layers, heads=heads,
            intermediate=intermediate or 4 * word_dim, max_len=max_len)
        if state_dict is None:
            flax_like_init_(self.module, torch.Generator().manual_seed(seed))
            self.weight_source = f"random-init(seed={seed})"
        else:
            self.module.load_state_dict(state_dict)
            self.weight_source = "state_dict"
        self.module.to(self.device).eval().requires_grad_(False)

    @property
    def hidden(self) -> int:
        """Width of the hidden states (the model's word_dim)."""
        return self.module.hidden

    @classmethod
    def from_hf(cls, lm: str, device="cuda") -> "FrozenLM":
        """Load a local HF checkpoint (registry key or name, resolved as
        ``utils.hf_import.resolve`` does) into the matching encoder:
        bert family / roberta / t5 / mpnet (the reference's seven --lm
        variants, bert_encoder.py:29-59). Raises when it is not there."""
        from ..utils.hf_import import load_hf_encoder
        from .encoder_variants import MPNetEncoder, T5Encoder
        state, dims = load_hf_encoder(lm)
        arch = dims.get("arch", "bert")
        if arch == "t5":
            module = T5Encoder(
                vocab_size=dims["vocab"], hidden=dims["hidden"],
                layers=dims["layers"], heads=dims["heads"],
                head_dim=dims["head_dim"], intermediate=dims["intermediate"],
                num_buckets=dims["num_buckets"],
                max_distance=dims["max_distance"], eps=dims["eps"])
        elif arch == "mpnet":
            module = MPNetEncoder(
                vocab_size=dims["vocab"], hidden=dims["hidden"],
                layers=dims["layers"], heads=dims["heads"],
                intermediate=dims["intermediate"], max_len=dims["max_len"],
                num_buckets=dims["num_buckets"], pad_idx=dims["pad_idx"],
                eps=dims["eps"])
        else:
            module = TransformerQuestionEncoder(
                vocab_size=dims["vocab"], hidden=dims["hidden"],
                layers=dims["layers"], heads=dims["heads"],
                intermediate=dims["intermediate"], max_len=dims["max_len"],
                position_style=arch, pad_idx=dims.get("pad_idx", 0))
        return cls(word_dim=dims["hidden"], state_dict=state, module=module,
                   device=device)

    @torch.inference_mode()
    def encode(self, tokens: np.ndarray, mask: Optional[np.ndarray] = None,
               pad_id: int = 0, batch: int = 256) -> np.ndarray:
        """tokens [N, L] -> hidden [N, L, D] (host numpy, chunked)."""
        tokens = np.asarray(tokens, dtype=np.int32)
        if mask is None:
            mask = (tokens != pad_id).astype(np.float32)
        outs = []
        for i in range(0, len(tokens), batch):
            tok = torch.from_numpy(tokens[i:i + batch]).to(self.device)
            m = torch.from_numpy(np.asarray(mask[i:i + batch], np.float32)).to(self.device)
            outs.append(self.module(tok, m).float().cpu().numpy())
        return np.concatenate(outs, axis=0) if outs else np.zeros(
            tokens.shape + (self.module.hidden,), np.float32)


def encode_relations(lm: FrozenLM, rel_tokens: np.ndarray,
                     rel_tokens_inv: np.ndarray, pad_id: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Relation surface-form states: (rel_hidden, rel_hidden_inv,
    rel_text_mask), each over ``[num_kb_relation + 1, Lr]`` (cli.py:216-219)."""
    return (lm.encode(rel_tokens, pad_id=pad_id),
            lm.encode(rel_tokens_inv, pad_id=pad_id),
            (rel_tokens != pad_id).astype(np.float32))


def encode_questions(lm: FrozenLM, ds, pad_id: int, max_len: int = 64) -> None:
    """Set ``ds.q_hidden`` to each question's frozen-LM token states, with
    the questions padded or cut to ``max_len`` tokens for the encoder
    (cli.py:226-236)."""
    if not ds.records:
        ds.q_hidden = []
        return
    hid = lm.encode(np.stack([np.pad(r.q_token_ids,
                                     (0, max(0, max_len - len(r.q_token_ids))))
                              [:max_len] for r in ds.records]), pad_id=pad_id)
    ds.q_hidden = [hid[i, :len(r.q_token_ids)] for i, r in enumerate(ds.records)]


def maybe_frozen_lm(lm: str, word_dim: int, seed: int = 0, logger=None,
                    device="cuda") -> FrozenLM:
    """HF weights when available, deterministic random encoder otherwise.

    The chosen source is logged LOUDLY and recorded on the returned object
    (``.weight_source``: ``hf:<lm>``, or ``random-init(seed=...; <exception
    type>: <text>)``), so a typo'd --lm or a broken checkpoint path can never
    silently train a different model (the reference hard-fails instead,
    bert_encoder.py:30-59; the JAX package degrades the same way for offline
    machines). The Trainer stamps it into checkpoint metadata."""
    logger = logger or logging.getLogger("gnn_rag_tpu_torch")
    try:
        enc = FrozenLM.from_hf(lm, device=device)
        enc.weight_source = f"hf:{lm}"
        logger.info("frozen LM: loaded HF weights for %r", lm)
        return enc
    except Exception as e:
        enc = FrozenLM(word_dim=word_dim, seed=seed, device=device)
        enc.weight_source = f"random-init(seed={seed}; {type(e).__name__}: {e})"
        logger.warning(
            "frozen LM: RANDOM INIT fallback for %r (%s: %s) — question/"
            "relation features use a deterministic random encoder, NOT "
            "pretrained weights", lm, type(e).__name__, e)
        return enc
