"""LLM backend registry, the port of gnn_rag_tpu/rag/llms/__init__.py
(reference: llm/src/llms/language_models/__init__.py:8-22).

The same keys in the same order: a name resolves to the first key that is a
substring of it, lowercased, so 'llama_tpu' and 'tpu-reader' take the
on-card reader (``LlamaTorch``, over the port's ``LlamaLM`` and
``Decoder``, with ``--quant int8`` weight-only int8 and ``--draft_path``
speculative decoding), 'RoG' and 'llama-2-7b' the HF Llama backend, and
'mock' the offline echo reader. ``serving`` serves any of them over the
OpenAI chat protocol. The backends that need ``transformers`` pipelines or
the OpenAI API (and a network) are not ported: constructing one raises
``NotImplementedError``.
"""

from .base import BaseLanguageModel
from .llama_torch import LlamaTorch
from .mock import MockLLM


def _unported(name: str, needs: str):
    class Unported(BaseLanguageModel):
        def __init__(self, args):
            raise NotImplementedError(
                f"the {name} reader backend is not ported to gnn_rag_tpu_torch: "
                f"it needs {needs}; use 'llama_tpu' (LlamaTorch) or 'mock' "
                f"(ROADMAP, Queue 1: the RAG half's HF and OpenAI backends)")
    Unported.__name__ = Unported.__qualname__ = name
    return Unported


ChatGPT = _unported("ChatGPT", "the OpenAI chat API over a network")
Alpaca = _unported("Alpaca", "a transformers text-generation pipeline")
Longchat = _unported("Longchat", "a transformers text-generation pipeline")
Llama = _unported("Llama", "a transformers text-generation pipeline")
FlanT5 = _unported("FlanT5", "a transformers text2text pipeline")

registed_language_models = {
    "gpt-4": ChatGPT,
    "gpt-3.5-turbo": ChatGPT,
    "alpaca": Alpaca,
    "longchat": Longchat,
    "tpu": LlamaTorch,     # the on-card LlamaLM reader (llm checkpoint)
    "llama": Llama,
    "flan-t5": FlanT5,
    "rog": Llama,
    "mock": MockLLM,
}


def get_registed_model(model_name: str):
    for key, value in registed_language_models.items():
        if key in model_name.lower():
            return value
    raise ValueError(f"No registered model found for name {model_name}")
