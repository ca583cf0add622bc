"""The LLM reader's serving and finetuning paths of gnn_rag_tpu_torch
(weight-only int8, remat, LoRA, speculative decoding) against the JAX
package on the CPU.

Inputs come from numpy seeds and flax inits; flax weights, int8 trees and
LoRA adapters cross over through ``bridge``. Tolerances:

* ``quantize_state_dict`` against ``quantize_params``: int8 weights equal,
  scales rtol 1e-7 (the same float32 division);
* int8 logits at D = 128 (dim 256, 2 heads, GQA 2:1, untied and tied):
  float32 1e-4 and bfloat16 2e-2 of max|logit| (those of
  test_torch_llm.py::test_llama_logits_match_flax);
* greedy and speculative decoding: identical token ids and stats;
* remat on against off: loss and every gradient bit for bit; the loss
  against the JAX ``remat=True`` model rtol 1e-5, its gradients 1e-4 of
  each tensor's largest entry + 1e-7;
* LoRA: the merge at init bit for bit; ``merge_lora`` against JAX's on the
  same adapters rtol 1e-6 + atol 1e-7 (A @ B sums r float32 products in
  either order); three Adam steps: losses rtol 1e-5, adapters after each
  step rtol 1e-4 + atol 1e-6 (test_sft_three_steps_match_jax's), the base
  bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_rag_tpu.llm_tpu import lora as jlora
from gnn_rag_tpu.llm_tpu.generate import Decoder as JDecoder
from gnn_rag_tpu.llm_tpu.generate import SpeculativeDecoder as JSpeculativeDecoder
from gnn_rag_tpu.llm_tpu.model import LlamaConfig as JLlamaConfig
from gnn_rag_tpu.llm_tpu.model import LlamaLM as JLlamaLM
from gnn_rag_tpu.llm_tpu.quant import param_bytes as jparam_bytes
from gnn_rag_tpu.llm_tpu.quant import quantize_params
from gnn_rag_tpu_torch import bridge
from gnn_rag_tpu_torch.llm.generate import Decoder, SpeculativeDecoder
from gnn_rag_tpu_torch.llm.lora import (DEFAULT_TARGETS, LoRATrainer,
                                        init_lora, merge_lora)
from gnn_rag_tpu_torch.llm.model import LlamaConfig, LlamaLM
from gnn_rag_tpu_torch.llm.quant import (QUANT_KERNELS, QuantLinear,
                                         param_bytes, quantize_kernel,
                                         quantize_state_dict)
from gnn_rag_tpu_torch.llm.sft import completion_loss

WIDE = dict(vocab_size=300, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
            intermediate=384, max_seq_len=256)
SPEC = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=4,
            intermediate=64, max_seq_len=256, dtype="float32")


def ported(state, **cfg):
    model = LlamaLM(LlamaConfig(**cfg))
    model.load_state_dict(state)
    return model.eval()


def jinit(seed, cfg, n=8):
    jm = JLlamaLM(JLlamaConfig(**cfg))
    return jm, jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, n), jnp.int32))


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def wide(request):
    """A flax LlamaLM at head dim 128, its params and their int8 tree."""
    cfg = dict(WIDE, tie_embeddings=request.param)
    tokens = np.random.default_rng(0).integers(3, 300, (2, 40)).astype(np.int32)
    _, params = jinit(0, dict(cfg, dtype="float32"))
    return cfg, tokens, params, quantize_params(params)


# ---------------------------------------------------------------- int8
def test_quantize_state_dict_matches_quantize_params(wide):
    cfg, _, params, qparams = wide
    got = quantize_state_dict(bridge.llama_from_flax(params))
    want = bridge.llama_from_flax(qparams)
    assert sorted(got) == sorted(want)
    n_q = 0
    for name, w in want.items():
        if name.endswith(".weight_q"):
            assert got[name].dtype == torch.int8 == w.dtype
            torch.testing.assert_close(got[name], w, rtol=0, atol=0, msg=name)
            n_q += 1
        else:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-7,
                                       atol=0, err_msg=name)
    assert n_q == 7 * WIDE["n_layers"] + (not cfg["tie_embeddings"])
    assert "tok_emb.weight" in got and "tok_emb.weight_q" not in got
    # the int8 model's state_dict holds exactly these entries and sizes
    model = ported(got, **cfg, quant="int8", dtype="float32")
    assert param_bytes(model.state_dict()) == jparam_bytes(qparams)


def test_quantize_kernel_rules():
    """Zero rows get scale 1, halves round to even, values clip to ±127,
    and W is rebuilt within half a scale."""
    w = torch.tensor([[0.0, 0.0, 0.0], [127.0, 0.5, -1.5], [2.5, 254.0, -254.0]])
    q, scale = quantize_kernel(w)
    assert scale.tolist() == [1.0, 1.0, 2.0]
    assert q.tolist() == [[0, 0, 0], [127, 0, -2], [1, 127, -127]]
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((48, 64)).astype(np.float32))
    q, scale = quantize_kernel(w)
    assert ((q.float() * scale[:, None] - w).abs() <= scale[:, None] / 2 + 1e-6).all()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_int8_logits_match_jax(wide, dtype, tol):
    cfg, tokens, _, qparams = wide
    jm = JLlamaLM(JLlamaConfig(**cfg, dtype=dtype, quant="int8"))
    want = np.asarray(jm.apply(qparams, jnp.asarray(tokens))[0])
    model = ported(bridge.llama_from_flax(qparams), **cfg, dtype=dtype,
                   quant="int8")
    assert sum(isinstance(m, QuantLinear) for m in model.modules()) == (
        7 * WIDE["n_layers"] + (not cfg["tie_embeddings"]))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_int8_greedy_matches_jax():
    jm, params = jinit(1, SPEC)
    qparams = quantize_params(params)
    jq = JLlamaLM(JLlamaConfig(**SPEC, quant="int8"))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 64, n).tolist() for n in (5, 17, 9)]
    want = JDecoder(jq, qparams, max_len=64).greedy_batch(prompts, 12)
    model = ported(bridge.llama_from_flax(qparams), **SPEC, quant="int8")
    assert Decoder(model, max_len=64).greedy_batch(prompts, 12) == want
    # the port's own quantization decodes the same
    own = ported(quantize_state_dict(bridge.llama_from_flax(params)), **SPEC,
                 quant="int8")
    assert Decoder(own, max_len=64).greedy_batch(prompts, 12) == want


# ---------------------------------------------------------------- remat
def batch(seed, vocab, B=3, L=33):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, vocab, (B, L)).astype(np.int32)
    mask = (rng.random((B, L)) < 0.6).astype(np.float32)
    return tokens, mask


def loss_and_grads(model, tokens, mask):
    for p in model.parameters():
        p.grad = None
    loss = completion_loss(model, torch.from_numpy(tokens).long(),
                           torch.from_numpy(mask))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def test_remat_matches_no_remat_bit_for_bit():
    """The loss and every parameter gradient; then LoRA adapters (the
    merged weights swapped in by functional_call) after two steps."""
    _, params = jinit(0, dict(WIDE, dtype="float32"))
    state = bridge.llama_from_flax(params)
    tokens, mask = batch(3, 300)
    plain = ported(state, **WIDE, dtype="float32").train()
    remat = ported(state, **WIDE, dtype="float32", remat=True).train()
    want = loss_and_grads(plain, tokens, mask)
    got = loss_and_grads(remat, tokens, mask)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for name, g in want[1].items():
        torch.testing.assert_close(got[1][name], g, rtol=0, atol=0, msg=name)
    adapters = {}
    for model in (plain, remat):
        lora = init_lora(model, torch.Generator().manual_seed(0))
        tr = LoRATrainer(model, lora, lr=1e-2)
        x, m = torch.from_numpy(tokens).long(), torch.from_numpy(mask)
        losses = [tr.train_step(x, m) for _ in range(2)]
        adapters[model.cfg.remat] = (losses, lora)
    assert adapters[False][0] == adapters[True][0]
    for name, ab in adapters[False][1].items():
        for k in ("a", "b"):
            torch.testing.assert_close(adapters[True][1][name][k], ab[k],
                                       rtol=0, atol=0, msg=name)


def test_remat_matches_jax_remat():
    cfg = dict(WIDE, dtype="float32")
    jm, params = jinit(0, dict(cfg, remat=True))
    tokens, mask = batch(4, 300)

    def jloss(p):
        logits, _ = jm.apply(p, jnp.asarray(tokens[:, :-1]))
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(tokens[:, 1:])[..., None],
                                   axis=-1)[..., 0]
        m = jnp.asarray(mask[:, 1:])
        return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    model = ported(bridge.llama_from_flax(params), **cfg, remat=True).train()
    loss, grads = loss_and_grads(model, tokens, mask)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_grads = bridge.llama_from_flax(want_grads)
    for name, g in want_grads.items():
        tol = 1e-4 * g.abs().max().item() + 1e-7
        assert (grads[name] - g).abs().max().item() <= tol, name


# ---------------------------------------------------------------- LoRA
def test_init_lora_shapes_and_merge_at_init():
    model = ported(bridge.llama_from_flax(jinit(0, dict(WIDE, dtype="float32"))[1]),
                   **WIDE, dtype="float32")
    lora = init_lora(model, torch.Generator().manual_seed(0), r=4)
    assert len(lora) == 2 * WIDE["n_layers"]
    assert all(any(t in n for t in DEFAULT_TARGETS) for n in lora)
    for name, ab in lora.items():
        d_out, d_in = model.state_dict()[name].shape
        assert ab["a"].shape == (d_in, 4) and ab["b"].shape == (4, d_out)
        assert not ab["b"].any()
    # A ~ randn / r: unit variance over r^2
    a = torch.cat([ab["a"].flatten() for ab in lora.values()])
    assert abs(a.std().item() * 4 - 1) < 0.05
    base = model.state_dict()
    merged = merge_lora(base, lora, alpha=16, r=4)
    for name, w in base.items():
        torch.testing.assert_close(merged[name], w, rtol=0, atol=0, msg=name)


def jax_lora(params, seed, r, scale_b=0.0):
    lora = jlora.init_lora(params, jax.random.PRNGKey(seed), r=r)
    if scale_b:
        rng = np.random.default_rng(seed)
        lora = {k: {"a": v["a"], "b": jnp.asarray(
            scale_b * rng.standard_normal(v["b"].shape).astype(np.float32))}
            for k, v in lora.items()}
    return lora


def test_merge_lora_matches_jax():
    _, params = jinit(0, dict(WIDE, dtype="float32"))
    lora = jax_lora(params, 1, r=8, scale_b=0.1)
    want = bridge.llama_from_flax(jlora.merge_lora(params, lora, 16.0, 8))
    ported_lora = bridge.lora_from_flax(lora)
    assert sorted(ported_lora) == sorted(
        f"layer_{i}.attn.{p}.weight" for i in range(2) for p in ("q_proj", "v_proj"))
    got = merge_lora(bridge.llama_from_flax(params), ported_lora, 16.0, 8)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_lora_three_steps_match_jax():
    """Three Adam (1e-2) steps of the adapters from the same base, adapters
    and batches as ``lora_train_step_factory`` with ``optax.adam``."""
    cfg = dict(WIDE, dtype="float32")
    jm, params = jinit(0, cfg)
    lora = jax_lora(params, 2, r=8)
    tokens, mask = batch(6, 300)
    step = jlora.lora_train_step_factory(jm, params, optax.adam(1e-2), 16.0, 8)
    jl = jax.tree_util.tree_map(jnp.array, lora)
    opt_state = optax.adam(1e-2).init(jl)
    model = ported(bridge.llama_from_flax(params), **cfg).train()
    base = {k: v.clone() for k, v in model.state_dict().items()}
    plora = bridge.lora_from_flax(lora)
    tr = LoRATrainer(model, plora, lr=1e-2, alpha=16.0, r=8)
    x, m = torch.from_numpy(tokens).long(), torch.from_numpy(mask)
    for _ in range(3):
        jl, opt_state, jloss = step(jl, opt_state, jnp.asarray(tokens),
                                    jnp.asarray(mask))
        loss = tr.train_step(x, m)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        want = bridge.lora_from_flax(jl)
        for name, ab in want.items():
            for k in ("a", "b"):
                np.testing.assert_allclose(plora[name][k].detach().numpy(),
                                           ab[k].numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=f"{name} {k}")
    assert all(p.grad is None and not p.requires_grad
               for p in model.parameters())
    for name, w in model.state_dict().items():
        torch.testing.assert_close(w, base[name], rtol=0, atol=0, msg=name)


# ---------------------------------------------------------------- speculative
@pytest.fixture(scope="module")
def spec_models():
    """TestSpeculativeDecoder's target (seed 0) and 1-layer drafts (seeds
    1 and 2), flax and ported."""
    out = {}
    for name, seed, layers in (("target", 0, 2), ("draft", 1, 1), ("draft2", 2, 1)):
        cfg = dict(SPEC, n_layers=layers)
        jm, params = jinit(seed, cfg)
        out[name] = (jm, params, ported(bridge.llama_from_flax(params), **cfg))
    return out


def run_both(spec_models, draft, gamma, prompt, max_new, eos_id=None):
    jt, tp, t = spec_models["target"]
    jd, dp, d = spec_models[draft]
    jspec = JSpeculativeDecoder(jt, tp, jd, dp, max_len=256, gamma=gamma)
    spec = SpeculativeDecoder(t, d, max_len=256, gamma=gamma)
    want = jspec.greedy(prompt, max_new, eos_id)
    got = spec.greedy(prompt, max_new, eos_id)
    assert got == want and spec.last_stats == jspec.last_stats, (
        got, want, spec.last_stats, jspec.last_stats)
    assert got == Decoder(t, max_len=256).greedy(prompt, max_new, eos_id)
    return spec.last_stats


@pytest.mark.parametrize("gamma", [1, 3])
def test_speculative_matches_jax_independent_draft(spec_models, gamma):
    for prompt in ([5, 9, 13, 2, 7], list(range(1, 33))):
        stats = run_both(spec_models, "draft", gamma, prompt, 24)
        assert stats["tokens"] == 24


def test_speculative_self_draft_accepts_everything(spec_models):
    stats = run_both(spec_models, "target", 4, [3, 1, 4, 1, 5], 20)
    assert stats == {"target_forwards": 5, "draft_accepted": 16, "tokens": 20}


def test_speculative_eos_stops_early(spec_models):
    t = spec_models["target"][2]
    prompt = [7, 7, 7, 7]
    eos = Decoder(t, max_len=256).greedy(prompt, 40)[2]
    stats = run_both(spec_models, "draft2", 3, prompt, 40, eos_id=eos)
    assert stats["tokens"] <= 3


def test_speculative_int8_target_matches_jax(spec_models):
    """An int8 target with a full-precision draft, as LlamaTorch --quant
    int8 --draft_path serves."""
    jt, tp, _ = spec_models["target"]
    jd, dp, d = spec_models["draft"]
    qparams = quantize_params(tp)
    jq = JLlamaLM(JLlamaConfig(**SPEC, quant="int8"))
    want = JSpeculativeDecoder(jq, qparams, jd, dp, max_len=96,
                               gamma=3).greedy([5, 2, 8, 1], 16)
    tq = ported(bridge.llama_from_flax(qparams), **SPEC, quant="int8")
    assert SpeculativeDecoder(tq, d, max_len=96, gamma=3).greedy(
        [5, 2, 8, 1], 16) == want == Decoder(tq, max_len=96).greedy([5, 2, 8, 1], 16)


def test_speculative_refuses_what_jax_asserts(spec_models):
    t, d = spec_models["target"][2], spec_models["draft"][2]
    with pytest.raises(ValueError, match="gamma"):
        SpeculativeDecoder(t, d, gamma=0)
    other = LlamaLM(LlamaConfig(**dict(SPEC, vocab_size=65)))
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeDecoder(t, other)
    with pytest.raises(ValueError, match="max_len"):
        SpeculativeDecoder(t, d, max_len=32, gamma=4).greedy(list(range(20)), 8)
