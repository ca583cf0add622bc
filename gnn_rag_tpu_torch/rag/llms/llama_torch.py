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

The reader builds on the card unless ``args.device == "cpu"`` and raises
without one. Two ``LlamaTPU`` options are not ported and raise
``NotImplementedError`` instead of decoding some other way: ``--quant int8``
(weight-only int8) and ``--draft_path`` (speculative decoding).
"""

from __future__ import annotations

import json
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
    """Registry backend: greedy decoding on the card with a kv cache."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("--model_path", type=str, default=None,
                            help="dir with config.json and checkpoint.pt "
                                 "(or the SFT's checkpoint-<step>.pt)")
        parser.add_argument("--max_new_tokens", type=int, default=64)
        parser.add_argument("--quant", type=str, default=None,
                            choices=["int8"],
                            help="weight-only int8 serving (not ported: "
                                 "raises)")
        parser.add_argument("--draft_path", type=str, default=None,
                            help="draft bundle for speculative decoding "
                                 "(not ported: raises)")
        parser.add_argument("--spec_gamma", type=int, default=4)
        parser.add_argument("--device", type=str, default="cuda",
                            choices=["cuda", "cpu"])

    def __init__(self, args, tokenizer=None):
        unported = {"--quant int8": getattr(args, "quant", None) == "int8",
                    "--draft_path (speculative decoding)":
                        bool(getattr(args, "draft_path", None))}
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(f"LlamaTorch: not ported: {', '.join(bad)}"
                                      f" (ROADMAP, Queue 1 item 4)")
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

    def prepare_for_inference(self, **kwargs):
        from ...llm.generate import Decoder
        from ...llm.model import LlamaConfig, LlamaLM
        from ...utils.checkpoint import load_state

        path = self.args.model_path
        vocab_path = os.path.join(path, "vocab.json")
        if os.path.exists(vocab_path):
            self.tok = WordTokenizer.load(vocab_path)
        with open(os.path.join(path, "config.json")) as f:
            raw = json.load(f)
        self.max_new = int(getattr(self.args, "max_new_tokens", 64) or 64)
        cfg = LlamaConfig(**raw)
        self.maximun_token = cfg.max_seq_len - self.max_new - 8
        with torch.device("meta"):
            model = LlamaLM(cfg)
        state = load_state(bundle_checkpoint(path), model.state_dict(),
                           partial=False)
        model.load_state_dict(state, assign=True)
        self.model = model.to(self.device).eval()
        self.decoder = Decoder(self.model, max_len=cfg.max_seq_len)

    def tokenize(self, text: str) -> int:
        return len(self.tok.encode(text))

    def generate_sentence(self, llm_input: str) -> str:
        # Decoder.greedy returns the NEW tokens only
        ids = self.tok.encode(llm_input)[-self.maximun_token:]
        out = self.decoder.greedy(ids, max_new_tokens=self.max_new,
                                  eos_id=self.tok.eos_id)
        return self.tok.decode(out).strip()

    def generate_batch(self, llm_inputs: List[str]) -> List[str]:
        prompts = [self.tok.encode(t)[-self.maximun_token:]
                   for t in llm_inputs]
        outs = self.decoder.greedy_batch(prompts, max_new_tokens=self.max_new,
                                         eos_id=self.tok.eos_id)
        return [self.tok.decode(o).strip() for o in outs]
