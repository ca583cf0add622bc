"""The port's HF and OpenAI reader backends (``rag.llms.hf_causal``,
``flan_t5``, ``openai_chat``) against the JAX package's, offline.

* A tiny ``LlamaForCausalLM`` and a tiny ``T5ForConditionalGeneration``,
  random weights from a seed, ``save_pretrained`` to tmp beside a
  ``BertTokenizer`` written from a hand-made vocab (``HF_HUB_OFFLINE=1``):
  ``Llama``, ``Alpaca``, ``Longchat`` (its ``rope_scaling`` linear, factor
  8, reaches the model) and ``FlanT5`` generate the same text as the JAX
  package's classes on the same directory, and count tokens the same.
* ``ChatGPT`` over a fake ``openai`` module (and no ``tiktoken``, which
  would download its tables): the request, the truncation to the token
  limit, ``retry + 1`` attempts with the 30 s backoff (``time.sleep``
  patched), and ``OPENAI_BASE_URL``; the same calls as the JAX class.
"""

import argparse
import sys
import types

import pytest

from gnn_rag_tpu.rag.llms import flan_t5 as jflan
from gnn_rag_tpu.rag.llms import hf_causal as jhf
from gnn_rag_tpu.rag.llms import openai_chat as jchat
from gnn_rag_tpu_torch.rag.llms import flan_t5, hf_causal, openai_chat

WORDS = ["who", "is", "the", "answer", "paris", "france", "capital", "of",
         "question", "reasoning", "paths", "->", "what", "language"]


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """Model directories: a tiny LLaMA and a tiny T5, each with a
    BertTokenizer over WORDS."""
    transformers = pytest.importorskip("transformers")
    import torch
    root = tmp_path_factory.mktemp("hf_readers")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    tok = transformers.BertTokenizer(str(root / "vocab.txt"))
    dirs = {}
    torch.manual_seed(0)
    llama = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=len(vocab), hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, pad_token_id=0, bos_token_id=2,
        eos_token_id=3))
    t5 = transformers.T5ForConditionalGeneration(transformers.T5Config(
        vocab_size=len(vocab), d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_heads=4, pad_token_id=0, eos_token_id=3,
        decoder_start_token_id=0))
    for name, model in (("llama", llama), ("t5", t5)):
        dirs[name] = root / name
        model.save_pretrained(dirs[name])
        tok.save_pretrained(dirs[name])
    return dirs


@pytest.fixture
def offline(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    import huggingface_hub.constants as hub
    monkeypatch.setattr(hub, "HF_HUB_OFFLINE", True)


def seeded(generate, prompt):
    """One generation from torch's global generator at seed 0 (the
    text-generation pipeline samples by default)."""
    import torch
    torch.manual_seed(0)
    return generate(prompt)


PROMPTS = ["who is the capital of france ?",
           "reasoning paths : paris -> capital of -> france question : what"]


@pytest.mark.parametrize("cls", ["Llama", "Alpaca", "Longchat"])
def test_hf_causal_generates_like_jax(hf_dirs, offline, cls):
    args = argparse.Namespace(model_path=str(hf_dirs["llama"]),
                              max_new_tokens=6, dtype="fp32")
    port, ref = getattr(hf_causal, cls)(args), getattr(jhf, cls)(args)
    assert port.maximun_token == ref.maximun_token
    port.prepare_for_inference()
    ref.prepare_for_inference()
    for prompt in PROMPTS:
        got, want = seeded(port.generate_sentence, prompt), seeded(
            ref.generate_sentence, prompt)
        assert isinstance(got, str) and got and got == want
        assert port.tokenize(prompt) == ref.tokenize(prompt) > 0
    scaling = port.generator.model.config.rope_scaling
    if cls == "Longchat":
        assert scaling["type"] == "linear" and scaling["factor"] == 8.0
    else:
        assert scaling is None


def test_flan_t5_generates_like_jax(hf_dirs, offline):
    args = argparse.Namespace(model_path=str(hf_dirs["t5"]), max_new_tokens=6)
    port, ref = flan_t5.FlanT5(args), jflan.FlanT5(args)
    assert port.maximun_token == ref.maximun_token == 512 - 5
    port.prepare_for_inference()
    ref.prepare_for_inference()
    for prompt in PROMPTS:
        got = seeded(port.generate_sentence, prompt)
        assert got == seeded(ref.generate_sentence, prompt)
        assert port.tokenize(prompt) == ref.tokenize(prompt)


class FakeOpenAI:
    """The slice of the ``openai`` client the backend uses; fails the
    first ``fail`` calls."""

    def __init__(self, log, fail):
        self.log, self.fail = log, fail

    def __call__(self, **kw):
        self.log.append(("client", kw))
        outer = self

        class Completions:
            def create(self, **req):
                outer.log.append(("create", req))
                if outer.fail > 0:
                    outer.fail -= 1
                    raise RuntimeError("rate limited")
                msg = types.SimpleNamespace(content="  Paris \n")
                return types.SimpleNamespace(
                    choices=[types.SimpleNamespace(message=msg)])

        return types.SimpleNamespace(
            chat=types.SimpleNamespace(completions=Completions()))


def chat_calls(mod, monkeypatch, prompt, fail, retry=2, model="gpt-4"):
    log, sleeps = [], []
    fake = types.ModuleType("openai")
    fake.OpenAI = FakeOpenAI(log, fail)
    monkeypatch.setitem(sys.modules, "openai", fake)
    monkeypatch.setitem(sys.modules, "tiktoken", None)   # no table download
    monkeypatch.setattr(mod.time, "sleep", sleeps.append)
    bot = mod.ChatGPT(argparse.Namespace(retry=retry, model_name=model))
    return bot.generate_sentence(prompt), log, sleeps


@pytest.mark.parametrize("fail", [0, 1, 3])
def test_chatgpt_requests_retries_and_truncation(monkeypatch, fail):
    monkeypatch.setenv("OPENAI_BASE_URL", "http://localhost:1/v1")
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    prompt = "who is the capital of france ? " * 1400     # 43,400 chars
    got = chat_calls(openai_chat, monkeypatch, prompt, fail)
    assert got == chat_calls(jchat, monkeypatch, prompt, fail)
    answer, log, sleeps = got
    assert log[0] == ("client", {"api_key": "EMPTY",
                                 "base_url": "http://localhost:1/v1"})
    creates = [req for kind, req in log if kind == "create"]
    assert len(creates) == min(fail + 1, 3)               # retry 2: 3 tries
    assert sleeps == [30] * min(fail, 3)
    assert answer == ("Paris" if fail < 3 else None)
    req = creates[0]
    assert req["model"] == "gpt-4" and req["timeout"] == 30
    # chars/4 + 150 tokens exceed gpt-4's 8192: cut to 8192 characters
    assert req["messages"] == [{"role": "user", "content": prompt[:8192]}]


def test_chatgpt_token_limits_match_jax():
    assert openai_chat.TOKEN_LIMITS == jchat.TOKEN_LIMITS
    for name in jchat.TOKEN_LIMITS:
        assert openai_chat.get_token_limit(name) == jchat.get_token_limit(name)
    with pytest.raises(NotImplementedError):
        openai_chat.get_token_limit("gpt-5")
