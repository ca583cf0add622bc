"""The on-card LlamaLM reader backend, the port of
gnn_rag_tpu/rag/llms/llama_tpu.py ``LlamaTPU`` (which stands in for the
reference's HF ``pipeline("text-generation")`` Llama backend,
llm/src/llms/language_models/llama.py:15-36).

It serves a reader bundle through the registry interface (the registry's
'tpu' key: ``--reader llama_tpu``, ``model_name="llama_tpu"``), decoding
greedily with the port's kv-cache ``llm.generate.Decoder``. A bundle is a
directory with

* ``config.json``: the ``LlamaConfig`` fields, as the JAX package writes it;
* the parameters as a ``LlamaLM`` state_dict: ``checkpoint.pt``, else the
  newest ``checkpoint-<step>.pt`` that ``python -m gnn_rag_tpu_torch.llm.sft``
  writes (a JAX bundle's orbax ``checkpoint/`` needs JAX to read; carry its
  parameters over with ``bridge.llama_from_flax``);
* optionally ``vocab.json``, a ``WordTokenizer``'s words; else the text is
  byte tokens (``ByteTokenizer``).

``--quant int8`` quantizes the projections at load (``llm.quant``,
weight-only int8) unless the bundle's config is int8 already.
``--draft_path`` names a smaller bundle with the same vocabulary:
``generate_sentence`` then decodes by ``llm.generate.SpeculativeDecoder``
with ``--spec_gamma`` draft tokens a round (the same tokens as greedy),
and the prompt budget loses another gamma + 1 slots; ``generate_batch``
always decodes with the plain ``Decoder``. A ``--spec_gamma`` below 1 logs
a warning and decodes plain greedy, as ``LlamaTPU`` does.

The reader builds on the card unless ``args.device == "cpu"`` and raises
without one.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
from typing import List

import torch

from ...llm.tokenizers import ByteTokenizer, WordTokenizer
from .base import BaseLanguageModel


def bundle_checkpoint(path: str) -> str:
    """The parameter file of bundle ``path``: ``checkpoint.pt``, else the
    ``checkpoint-<step>.pt`` of the largest step."""
    whole = os.path.join(path, "checkpoint.pt")
    if os.path.isfile(whole):
        return whole
    steps = [int(m.group(1)) for name in os.listdir(path)
             if (m := re.fullmatch(r"checkpoint-(\d+)\.pt", name))]
    if not steps:
        raise FileNotFoundError(f"{path}: no checkpoint.pt or "
                                f"checkpoint-<step>.pt")
    return os.path.join(path, f"checkpoint-{max(steps)}.pt")


class LlamaTorch(BaseLanguageModel):
    """Registry backend: greedy (or speculative) decoding on the card with a
    kv cache."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("--model_path", type=str, default=None,
                            help="dir with config.json and checkpoint.pt "
                                 "(or the SFT's checkpoint-<step>.pt)")
        parser.add_argument("--max_new_tokens", type=int, default=64)
        parser.add_argument("--quant", type=str, default=None,
                            choices=["int8"],
                            help="weight-only int8 serving: quantize the "
                                 "checkpoint at load (llm.quant)")
        parser.add_argument("--draft_path", type=str, default=None,
                            help="dir with a smaller reader bundle sharing "
                                 "this vocab: single-prompt generation uses "
                                 "speculative draft-and-verify decoding "
                                 "(the same tokens as greedy)")
        parser.add_argument("--spec_gamma", type=int, default=4)
        parser.add_argument("--device", type=str, default="cuda",
                            choices=["cuda", "cpu"])

    def __init__(self, args, tokenizer=None):
        device = getattr(args, "device", None) or "cuda"
        if device != "cpu" and not torch.cuda.is_available():
            raise RuntimeError("LlamaTorch on cuda: torch.cuda.is_available() "
                               "is false (set device 'cpu' to run on the CPU)")
        self.args = args
        self.device = torch.device(device)
        self.tok = tokenizer or ByteTokenizer()
        self.maximun_token = 4096 - 100  # overwritten from config at load

    def load_model(self, **kwargs):
        self.prepare_for_inference(**kwargs)
        return self

    def _load(self, path: str, quant=None):
        """The bundle at ``path`` as an eval ``LlamaLM`` on the device,
        quantized when ``quant`` is "int8" and the bundle is not."""
        from ...llm.model import LlamaConfig, LlamaLM
        from ...llm.quant import quantize_state_dict
        from ...utils.checkpoint import load_state

        with open(os.path.join(path, "config.json")) as f:
            cfg = LlamaConfig(**json.load(f))
        with torch.device("meta"):
            model = LlamaLM(cfg)
        state = load_state(bundle_checkpoint(path), model.state_dict(),
                           partial=False)
        if quant == "int8" and cfg.quant != "int8":
            state = quantize_state_dict({k: v.to(self.device)
                                         for k, v in state.items()})
            with torch.device("meta"):
                model = LlamaLM(dataclasses.replace(cfg, quant="int8"))
        model.load_state_dict(state, assign=True)
        return model.to(self.device).eval()

    def prepare_for_inference(self, **kwargs):
        from ...llm.generate import Decoder, SpeculativeDecoder

        path = self.args.model_path
        vocab_path = os.path.join(path, "vocab.json")
        if os.path.exists(vocab_path):
            self.tok = WordTokenizer.load(vocab_path)
        self.max_new = int(getattr(self.args, "max_new_tokens", 64) or 64)
        self.model = self._load(path, getattr(self.args, "quant", None))
        max_len = self.model.cfg.max_seq_len
        self.maximun_token = max_len - self.max_new - 8
        self.decoder = Decoder(self.model, max_len=max_len)
        self.spec = None
        draft_path = getattr(self.args, "draft_path", None)
        gamma = getattr(self.args, "spec_gamma", 4)
        gamma = 4 if gamma is None else int(gamma)
        if draft_path and gamma < 1:
            logging.getLogger(__name__).warning(
                "spec_gamma=%d < 1: speculative decoding disabled, "
                "decoding plain greedy", gamma)
            draft_path = None
        if draft_path:
            self.spec = SpeculativeDecoder(self.model, self._load(draft_path),
                                           max_len=max_len, gamma=gamma)
            # speculation needs gamma + 1 cache slots beyond max_new
            self.maximun_token = max_len - self.max_new - (gamma + 1) - 8

    def tokenize(self, text: str) -> int:
        return len(self.tok.encode(text))

    def generate_sentence(self, llm_input: str) -> str:
        # Decoder.greedy returns the NEW tokens only
        ids = self.tok.encode(llm_input)[-self.maximun_token:]
        dec = self.spec if self.spec is not None else self.decoder
        out = dec.greedy(ids, max_new_tokens=self.max_new,
                         eos_id=self.tok.eos_id)
        return self.tok.decode(out).strip()

    def generate_batch(self, llm_inputs: List[str]) -> List[str]:
        prompts = [self.tok.encode(t)[-self.maximun_token:]
                   for t in llm_inputs]
        outs = self.decoder.greedy_batch(prompts, max_new_tokens=self.max_new,
                                         eos_id=self.tok.eos_id)
        return [self.tok.decode(o).strip() for o in outs]
