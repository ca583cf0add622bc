"""LLM backend registry, the port of gnn_rag_tpu/rag/llms/__init__.py
(reference: llm/src/llms/language_models/__init__.py:8-22).

The same keys in the same order: a name resolves to the first key that is a
substring of it, lowercased, so 'llama_tpu' and 'tpu-reader' take the
on-card reader (``LlamaTorch``, over the port's ``LlamaLM`` and
``Decoder``, with ``--quant int8`` weight-only int8 and ``--draft_path``
speculative decoding), 'RoG' and 'llama-2-7b' the HF Llama backend
(``hf_causal``: a ``transformers`` text-generation pipeline over a local
or cached checkpoint), 'flan-t5' the HF text2text backend, 'gpt-4' and
'gpt-3.5-turbo' the OpenAI chat client (any server of the protocol at
``OPENAI_BASE_URL``), and 'mock' the offline echo reader. ``serving``
serves any of them over the OpenAI chat protocol. ``transformers`` and
``openai`` are imported only when a backend prepares for inference.
"""

from .base import BaseLanguageModel
from .hf_causal import Alpaca, Llama, Longchat
from .flan_t5 import FlanT5
from .llama_torch import LlamaTorch
from .openai_chat import ChatGPT
from .mock import MockLLM

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
