"""HuggingFace causal-LM backends: Llama/RoG, Alpaca, Longchat, the port
of gnn_rag_tpu/rag/llms/hf_causal.py (the classes are copied unchanged).

Interface parity with the reference backends (llm/src/llms/language_models/
llama.py:15-36, alpaca.py, longchat/longchat.py). Token budgets follow the
reference: llama 4096-100, alpaca 2048-100, longchat 16384-100.

Long-context handling: the reference monkey-patches HF LLaMA with RoPE
position-interpolation ("condense", ratio 8) and CUDA flash-attention. The
port's own reader (``llama_torch.LlamaTorch`` over ``llm.model``, with
``rope_condense`` and the Hopper flash kernels) is the on-card path; this
HF path applies the condense ratio through ``rope_scaling`` (linear, factor
8), which transformers supports natively. ``transformers`` is imported only
in ``prepare_for_inference``: the weights and tokenizer come from a local
directory or the HF cache (``HF_HUB_OFFLINE=1`` keeps it off the network).
"""

from __future__ import annotations

from .base import BaseLanguageModel


class Llama(BaseLanguageModel):
    DTYPES = {"fp32": "float32", "fp16": "float16", "bf16": "bfloat16"}
    context_len = 4096

    @staticmethod
    def add_args(parser):
        parser.add_argument("--model_path", type=str,
                            default="meta-llama/Llama-2-7b-chat-hf")
        parser.add_argument("--max_new_tokens", type=int, default=512)
        parser.add_argument("--dtype", choices=["fp32", "fp16", "bf16"],
                            default="fp16")

    def __init__(self, args):
        self.args = args
        self.maximun_token = self.context_len - 100
        self.tokenizer = None
        self.generator = None

    def tokenize(self, text: str) -> int:
        return len(self.tokenizer.tokenize(text))

    def _extra_model_kwargs(self) -> dict:
        return {}

    def prepare_for_inference(self, **model_kwargs):
        import torch
        from transformers import AutoTokenizer, pipeline
        self.tokenizer = AutoTokenizer.from_pretrained(self.args.model_path,
                                                       use_fast=False)
        model_kwargs.update(self._extra_model_kwargs())
        self.generator = pipeline(
            "text-generation", model=self.args.model_path,
            tokenizer=self.tokenizer, device_map="auto",
            model_kwargs=model_kwargs,
            torch_dtype=getattr(torch, self.DTYPES[self.args.dtype]))

    def generate_sentence(self, llm_input: str):
        import torch
        with torch.inference_mode():
            outputs = self.generator(llm_input, return_full_text=False,
                                     max_new_tokens=self.args.max_new_tokens)
        return outputs[0]["generated_text"]


class Alpaca(Llama):
    """2048-token context (reference alpaca.py:15)."""
    context_len = 2048

    @staticmethod
    def add_args(parser):
        parser.add_argument("--model_path", type=str,
                            default="tatsu-lab/alpaca-7b-wdiff")
        parser.add_argument("--max_new_tokens", type=int, default=512)
        parser.add_argument("--dtype", choices=["fp32", "fp16", "bf16"],
                            default="fp16")


class Longchat(Llama):
    """16k context via RoPE position interpolation (reference
    longchat.py:27 + llama_condense_monkey_patch.py:18-55: ratio 8)."""
    context_len = 16384
    condense_ratio = 8

    @staticmethod
    def add_args(parser):
        parser.add_argument("--model_path", type=str,
                            default="lmsys/longchat-7b-16k")
        parser.add_argument("--max_new_tokens", type=int, default=512)
        parser.add_argument("--dtype", choices=["fp32", "fp16", "bf16"],
                            default="fp16")

    def _extra_model_kwargs(self) -> dict:
        # native HF equivalent of the reference's CondenseRotaryEmbedding
        return {"rope_scaling": {"type": "linear",
                                 "factor": float(self.condense_ratio)}}
