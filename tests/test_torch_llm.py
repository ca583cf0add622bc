"""The LLM reader of gnn_rag_tpu_torch against the JAX package on the CPU.

Inputs come from numpy seeds; flax weights cross over through
``bridge.llama_from_flax``. Tolerances:

* flash attention, plain versions vs the Pallas kernels in interpret mode
  (B2 L256 H2 D128, float32): o and lse 2e-4, dq/dk/dv 5e-4 (those of
  tests/test_llm_tpu.py; the two sum in other orders);
* LlamaLM logits at D = 128 (dim 256, 2 heads, 2 layers): float32 1e-4 and
  bfloat16 2e-2 of max|logit| (bf16 rounds at the same places in both, but
  the two frameworks' bf16 matmuls accumulate in other orders);
* three SFT steps (clip, AdamW, warmup-cosine from lr 0): each loss rtol
  1e-5, parameters after each step rtol 1e-4 + atol 1e-6 (elements whose
  gradient RMS is at float32's noise floor: within 3 lr, see the test);
* greedy decoding: identical token ids;
* beam search: identical sequences, scores and normalised scores within
  1e-5 (both sum float32 log-probs in the same order);
* ``load_hf_llama``: logits within 1e-4 of the HF forward and of the JAX
  loader's flax model (float32); beams as HF ``generate``'s, scores within
  2e-4 (tests/test_decode_hf_parity.py's tolerance).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rag_tpu.llm_tpu import flash_attention as jfa
from gnn_rag_tpu.llm_tpu.convert_hf import load_hf_llama as jload_hf_llama
from gnn_rag_tpu.llm_tpu.generate import Decoder as JDecoder
from gnn_rag_tpu.llm_tpu.model import LlamaConfig as JLlamaConfig
from gnn_rag_tpu.llm_tpu.model import LlamaLM as JLlamaLM
from gnn_rag_tpu.llm_tpu.sft import SFTConfig as JSFTConfig
from gnn_rag_tpu.llm_tpu.sft import SFTTrainer as JSFTTrainer
from gnn_rag_tpu.llm_tpu.sft import resize_embeddings as jresize_embeddings
from gnn_rag_tpu_torch import bridge
from gnn_rag_tpu_torch.llm import flash_attention as fa
from gnn_rag_tpu_torch.llm.convert_hf import load_hf_llama
from gnn_rag_tpu_torch.llm.generate import Decoder
from gnn_rag_tpu_torch.llm.model import (LlamaConfig, LlamaLM, build_llama,
                                         flash_applies)
from gnn_rag_tpu_torch.llm.sft import (SFTConfig, SFTTrainer,
                                       chunked_completion_loss,
                                       completion_loss, resize_embeddings,
                                       warmup_cosine_lr)

WIDE = dict(vocab_size=300, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
            intermediate=384, max_seq_len=256)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def ported(jparams, **cfg):
    model = LlamaLM(LlamaConfig(**cfg))
    model.load_state_dict(bridge.llama_from_flax(jparams))
    return model.eval()


@pytest.fixture(scope="module")
def wide():
    """A flax LlamaLM at head dim 128 (GQA 2:1) and its params."""
    tokens = np.random.default_rng(0).integers(3, 300, (2, 40)).astype(np.int32)
    jm = JLlamaLM(JLlamaConfig(**WIDE, dtype="float32"))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:, :8]))
    return tokens, params


def test_flash_forward_plain_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    q, k, v = (rand(rng, 2, 256, 2, 128) for _ in range(3))
    jo, jlse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), interpret=True)
    o, lse = fa.flash_fwd(t(q), t(k), t(v))       # CPU: the plain version
    assert o.dtype == torch.float32 and lse.shape == (4, 256)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-4,
                               atol=2e-4)


def test_flash_backward_plain_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    q, k, v, g = (rand(rng, 2, 256, 2, 128) for _ in range(4))
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jo, jlse = jfa._flash_fwd_impl(jq, jk, jv, interpret=True)
    want = jfa._flash_bwd_impl(jq, jk, jv, jo, jlse, jg, interpret=True)
    o, lse = fa.flash_fwd_plain(t(q), t(k), t(v))
    got = fa.flash_bwd(t(q), t(k), t(v), o, lse, t(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4,
                                   atol=5e-4, err_msg=name)
    # the autograd op gives the same gradients through its CPU path
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    fa.flash_attention(tq, tk, tv).backward(t(g))
    for name, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_flash_plain_bf16_rounds_p_and_keeps_type():
    """bf16 inputs: o in bf16, lse float32, p rounded to bf16 before PV."""
    rng = np.random.default_rng(2)
    q, k, v = (t(rand(rng, 1, 130, 1, 128)).bfloat16() for _ in range(3))
    o, lse = fa.flash_fwd_plain(q, k, v)
    o32, lse32 = fa.flash_fwd_plain(q.float(), k.float(), v.float())
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(lse, lse32, rtol=0, atol=0)
    err = (o.float() - o32).abs().max().item()
    assert 0 < err <= 2e-2 * o32.abs().max().item()


def bf16_tol(b):
    """chip_smoke.bf16_tol with one rounding: 2^-7 |b| + 1e-2 rms over the
    last axis + 1e-3 rms(b)."""
    sq = b.float().square()
    return (2 ** -7 * sq.sqrt() + 1e-2 * sq.mean(-1, keepdim=True).sqrt()
            + 1e-3 * sq.mean().sqrt())


def test_dkv_two_term_split_stays_within_tolerance():
    """The bf16 dk/dv kernel feeds the float p^T and ds^T to the tensor
    cores as two bf16 terms, hi + mid, with float sums. Emulated here: each
    product is off by at most 2^-16 of its size, and dk and dv stay within
    half the card check's tolerance of the plain version's float values
    (and within it once both are rounded to bf16)."""
    rng = np.random.default_rng(3)
    q, k, v, g = (t(rand(rng, 1, 300, 2, 128)).bfloat16() for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v)
    delta = fa.bwd_delta(o, g)
    p, ds = fa._dscores(q, k, v, g, lse, delta)        # float [B, H, L, S]

    def terms(x):
        hi = x.bfloat16().float()
        return hi, (x - hi).bfloat16().float()

    def product(x, y, dtype=torch.float32):
        return torch.einsum("bhls,blhd->bshd", x.to(dtype), y.to(dtype))

    got = [sum(product(part, y) for part in terms(x)) for x, y in
           ((ds, q), (p, g))]
    # the split alone, in float64: |sum (hi + mid - x) y| <= 2^-16 sum |x y|
    for x, y in ((ds, q), (p, g)):
        err = (sum(product(part, y, torch.float64) for part in terms(x))
               - product(x, y, torch.float64)).abs()
        assert (err <= 2 ** -16 * product(x.abs(), y.abs(), torch.float64)).all()
    exact = fa.flash_dkv_plain(q.float(), k.float(), v.float(), g.float(),
                               lse, delta)
    rounded = fa.flash_dkv_plain(q, k, v, g, lse, delta)
    for name, a, want, want_bf16 in zip(("dk", "dv"), got, exact, rounded):
        tol = bf16_tol(want_bf16)
        assert ((a - want).abs() / tol).max() <= 0.5, name
        assert ((a.bfloat16().float() - want_bf16.float()).abs() / tol
                ).max() <= 1, name


def test_dq_two_term_split_stays_within_tolerance():
    """The bf16 dq kernel feeds the float ds to the tensor cores as two
    bf16 terms, hi + mid, with float sums (as dk/dv does). Emulated here:
    dq stays within half the card check's tolerance of the plain version's
    float values, and within it once both are rounded to bf16."""
    rng = np.random.default_rng(4)
    q, k, v, g = (t(rand(rng, 1, 300, 2, 128)).bfloat16() for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v)
    delta = fa.bwd_delta(o, g)
    _, ds = fa._dscores(q, k, v, g, lse, delta)
    hi = ds.bfloat16().float()
    parts = (hi, (ds - hi).bfloat16().float())
    got = sum(torch.einsum("bhls,bshd->blhd", x, k.float()) for x in parts)
    exact = fa.flash_dq_plain(q.float(), k.float(), v.float(), g.float(),
                              lse, delta)
    rounded = fa.flash_dq_plain(q, k, v, g, lse, delta)
    tol = bf16_tol(rounded)
    assert ((got - exact).abs() / tol).max() <= 0.5
    assert ((got.bfloat16().float() - rounded.float()).abs() / tol).max() <= 1


@pytest.mark.parametrize("head_dim,dtype,device,cached,masked,want", [
    (128, torch.bfloat16, "cuda", False, False, True),
    (128, torch.float32, "cuda", False, False, True),
    (256, torch.bfloat16, "cuda", False, False, True),
    (384, torch.float32, "cuda", False, False, True),    # float32 to 512
    (128, torch.float16, "cuda", False, False, True),    # every type
    (64, torch.bfloat16, "cuda", False, False, False),
    (128, torch.bfloat16, "cpu", False, False, False),
    (128, torch.bfloat16, "cuda", True, False, False),   # kv cache (decode)
    (128, torch.bfloat16, "cuda", False, True, False),   # kv_valid
    (256, torch.float32, "cuda", False, False, True),    # 256 in both types
    (256, torch.float16, "cuda", False, False, True),
    (128, torch.float16, "cpu", False, False, False),
    (384, torch.bfloat16, "cuda", False, False, True),   # 16-bit clusters
    (384, torch.float16, "cuda", False, False, True),
    (512, torch.bfloat16, "cuda", False, False, True),
    (512, torch.float16, "cuda", False, False, True),
    (512, torch.float32, "cuda", False, False, True),
    (512, torch.bfloat16, "cpu", False, False, False),
    (512, torch.float16, "cuda", True, False, False),
    (640, torch.bfloat16, "cuda", False, False, True),   # 16-bit to 4096
    (640, torch.float16, "cuda", False, False, True),
    (4224, torch.bfloat16, "cuda", False, False, False),
    (4224, torch.float16, "cuda", False, False, False),
    (256, torch.float32, "cpu", False, False, False),
    (256, torch.bfloat16, "cpu", False, False, False),
    (256, torch.bfloat16, "cuda", True, False, False),
    (256, torch.bfloat16, "cuda", False, True, False),
    (640, torch.float32, "cuda", False, False, True),    # float32 to 2048
    (384, torch.float32, "cpu", False, False, False),
    (512, torch.float32, "cuda", False, True, False)])
def test_flash_rule_takes_the_kernels_only_where_they_apply(
        head_dim, dtype, device, cached, masked, want):
    assert flash_applies(True, head_dim, dtype, device, cached, masked) is want
    assert not flash_applies(False, head_dim, dtype, device, cached, masked)


def test_head_dim_256_and_float16_run_reference_attention():
    """What the kernels do not take (any CPU tensor) goes through
    reference_attention, which computes what the JAX model computes: a
    head-dim-256 float32 model's logits on the CPU against the flax model's
    (on the card that model runs the float32 kernels), and finite logits of
    a float16 model on the CPU (on the card it runs the float16 kernels;
    tests/test_torch_flash_f16.py holds its logits to the flax model's)."""
    cfg = dict(vocab_size=64, dim=256, n_layers=1, n_heads=1, n_kv_heads=1,
               intermediate=128, max_seq_len=64)
    tokens = np.random.default_rng(2).integers(3, 64, (2, 12)).astype(np.int32)
    jm = JLlamaLM(JLlamaConfig(**cfg, dtype="float32"))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(tokens))
    want, _ = jm.apply(params, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = ported(params, **cfg, dtype="float32")(t(tokens).long())
        half, _ = ported(params, **{**cfg, "n_heads": 2, "n_kv_heads": 2},
                         dtype="float16")(t(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())
    assert torch.isfinite(half).all()


def test_flash_wrapper_refuses_other_devices():
    x = torch.zeros(1, 8, 1, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_fwd(x, x, x)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_llama_logits_match_flax(wide, dtype, tol):
    tokens, params = wide
    jm = JLlamaLM(JLlamaConfig(**WIDE, dtype=dtype))
    want, _ = jm.apply(params, jnp.asarray(tokens))
    model = ported(params, **WIDE, dtype=dtype)
    with torch.no_grad():
        got, _ = model(t(tokens).long())
        hidden, _ = model(t(tokens).long(), return_hidden=True)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and hidden.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_llama_bridge_round_trip(wide):
    _, params = wide
    back = bridge.llama_to_flax(bridge.llama_from_flax(params))["params"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"]):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert "lm_head.weight" in bridge.llama_from_flax(params)


def test_resize_embeddings_matches_jax(wide):
    _, params = wide
    got = resize_embeddings(bridge.llama_from_flax(params), 300, 304)
    want = bridge.llama_from_flax(jresize_embeddings(
        jax.tree_util.tree_map(np.array, params), 300, 304))
    for name in ("tok_emb.weight", "lm_head.weight"):
        assert got[name].shape == (304, 256)
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    model = LlamaLM(LlamaConfig(**{**WIDE, "vocab_size": 304}))
    model.load_state_dict(got)


def test_llama_unported_options_raise(wide):
    """``quant="int8"`` and ``remat=True`` (once refused, now ported) build
    and run: int8 projections and head from ``quantize_state_dict``, logits
    close to full precision; remat the same logits; an unknown ``quant``
    raises (tests/test_torch_reader_paths.py holds both to the JAX
    package)."""
    from gnn_rag_tpu_torch.llm.quant import QuantLinear, quantize_state_dict
    tokens, params = wide
    full = ported(params, **WIDE, dtype="float32")
    q = LlamaLM(LlamaConfig(**WIDE, dtype="float32", quant="int8"))
    q.load_state_dict(quantize_state_dict(bridge.llama_from_flax(params)))
    assert isinstance(q.lm_head, QuantLinear) and q.tok_emb.weight.dtype == torch.float32
    remat = ported(params, **WIDE, dtype="float32", remat=True)
    x = t(tokens).long()
    with torch.no_grad():
        want, got = full(x)[0], q(x)[0]
        torch.testing.assert_close(remat(x)[0], want, rtol=0, atol=0)
    cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), 0)
    assert cos > 0.999
    with pytest.raises(ValueError, match="quant"):
        LlamaLM(LlamaConfig(**WIDE, quant="int4"))


def test_kv_cache_prefill_matches_cache_free_forward(wide):
    tokens, params = wide
    model = ported(params, **WIDE, dtype="float32")
    x = t(tokens).long()
    with torch.no_grad():
        full, _ = model(x)
        dec = Decoder(model, max_len=64)
        pre, _, _ = dec.prefill(x, torch.ones(x.shape))
    torch.testing.assert_close(pre, full, rtol=1e-5, atol=1e-5)


def test_chunked_loss_matches_dense(wide):
    tokens, params = wide
    model = ported(params, **WIDE, dtype="float32")
    mask = t((np.arange(40) > 10).astype(np.float32))[None].expand(2, 40)
    x = t(tokens).long()
    dense = completion_loss(model, x, mask)
    chunked = chunked_completion_loss(model, x, mask, chunk=16)
    torch.testing.assert_close(chunked, dense, rtol=1e-6, atol=1e-6)


def test_warmup_cosine_matches_optax():
    """optax evaluates the schedule in float32, the port in float64."""
    import optax
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 3, 11)
    for step in range(14):
        assert warmup_cosine_lr(step, 3e-4, 3, 11) == pytest.approx(
            float(sched(step)), rel=1e-5, abs=1e-12)


def test_sft_three_steps_match_jax(wide, tmp_path):
    """Three SFTTrainer steps from the same weights and batches: the clip
    bites (grad_clip 0.5), weight decay 0.01, lr 0 at step 0, then warmup
    and cosine; losses and every parameter after each step agree."""
    _, params = wide
    rng = np.random.default_rng(3)
    tokens = rng.integers(3, 300, (6, 33)).astype(np.int32)
    mask = (rng.random((6, 33)) < 0.6).astype(np.float32)
    kw = dict(learning_rate=1e-3, weight_decay=0.01, warmup_steps=1,
              total_steps=3, batch_size=4, grad_clip=0.5, save_every=1000)
    jtr = JSFTTrainer(JLlamaConfig(**WIDE, dtype="float32"),
                      JSFTConfig(output_dir=str(tmp_path / "j"), **kw),
                      params=jax.tree_util.tree_map(jnp.array, params))
    tr = SFTTrainer(LlamaConfig(**WIDE, dtype="float32"),
                    SFTConfig(output_dir=str(tmp_path / "t"), **kw),
                    params=bridge.llama_from_flax(params), device="cpu")
    noisy = {}
    for step in (1, 2, 3):
        jloss = jtr.train(tokens, mask, steps=step, resume=False)
        loss = tr.train(tokens, mask, steps=step, resume=False)
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        want = bridge.llama_from_flax(jtr.params)
        for name, p in tr.model.named_parameters():
            # Adam divides by the gradient's RMS, so an element whose
            # gradients all sit at float32's noise floor (RMS below 1e-4 of
            # the tensor's largest; one embedding element here, at 1e-7
            # against entries up to 0.2) moves by a step of O(lr) whose
            # size is noise on both sides: those are held to 3 lr from then
            # on, every other element to the tolerance
            rms = (tr.opt.state[p]["exp_avg_sq"] / (1 - 0.999 ** step)).sqrt()
            noise = noisy[name] = noisy.get(name, False) | (
                (rms > 0) & (rms < 1e-4 * rms.max())).numpy()
            got, ref = p.detach().numpy(), want[name].numpy()
            np.testing.assert_allclose(got[~noise], ref[~noise], rtol=1e-4,
                                       atol=1e-6, err_msg=name)
            assert np.abs(got[noise] - ref[noise]).max(initial=0) <= 3e-3, name
    assert tr.step == jtr.step == 3


def test_sft_save_and_resume(tmp_path):
    cfg = LlamaConfig(**{**WIDE, "n_layers": 1}, dtype="float32")
    scfg = SFTConfig(output_dir=str(tmp_path), learning_rate=1e-3,
                     total_steps=4, batch_size=2, save_every=2)
    rng = np.random.default_rng(4)
    tokens = rng.integers(3, 300, (4, 17)).astype(np.int32)
    mask = np.ones((4, 17), np.float32)
    tr = SFTTrainer(cfg, scfg, device="cpu")
    losses = tr.train(tokens, mask, steps=2)
    assert len(losses) == 2 and tr.last_checkpoint() == 2
    again = SFTTrainer(cfg, scfg, device="cpu")
    assert again.maybe_resume() and again.step == 2
    for name, p in tr.model.state_dict().items():
        torch.testing.assert_close(again.model.state_dict()[name], p,
                                   rtol=0, atol=0)
    assert len(again.train(tokens, mask, steps=4)) == 2


def test_sft_refuses_sharding():
    """``dp * tp > 1`` builds a mesh, which needs a process group (a
    ``torchrun`` launch; tests/test_torch_scaleout.py runs SFT over one):
    outside one it raises."""
    with pytest.raises(RuntimeError, match="no process group"):
        SFTTrainer(LlamaConfig(**WIDE), SFTConfig(dp=2), device="cpu")


@pytest.mark.parametrize("eos_id", [None, 7])
def test_greedy_batch_matches_jax(eos_id):
    """Ragged left-padded prompts through the kv-cache decoder (float32):
    the same token ids."""
    cfg = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
               intermediate=128, max_seq_len=128, dtype="float32")
    jm = JLlamaLM(JLlamaConfig(**cfg))
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 128, n).tolist() for n in (5, 17, 9)]
    want = JDecoder(jm, params, max_len=64).greedy_batch(prompts, 12, eos_id)
    got = Decoder(ported(params, **cfg), max_len=64).greedy_batch(
        prompts, 12, eos_id)
    assert got == want
    assert Decoder(ported(params, **cfg), max_len=64).greedy(
        prompts[1], 12, eos_id) == want[1]


def test_build_llama_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the CPU-only refusal is not testable")
    with pytest.raises((RuntimeError, AssertionError)):
        build_llama(LlamaConfig(**WIDE))


BEAM = dict(vocab_size=259, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
            intermediate=64, max_seq_len=128, dtype="float32")


@pytest.fixture(scope="module")
def beam_pair():
    """A tiny flax LlamaLM, the same weights in the port's, ragged prompts,
    and a token that the port's best beams emit (used as eos)."""
    jm = JLlamaLM(JLlamaConfig(**BEAM))
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, 259, n).tolist() for n in (5, 9, 3, 12)]
    model = ported(params, **BEAM)
    beams = Decoder(model, max_len=64).beam_search_batch(prompts, 3, 10)
    return jm, params, model, prompts, beams[1][0][0][3]


@pytest.mark.parametrize("num_beams", [1, 3])
@pytest.mark.parametrize("with_eos", [False, True])
def test_beam_search_batch_matches_jax(beam_pair, num_beams, with_eos):
    """Ragged left-padded prompts, with no eos or with one that ends some
    beams early: the JAX decoder's sequences, scores and their softmax."""
    jm, params, model, prompts, hit = beam_pair
    eos = hit if with_eos else None
    want = JDecoder(jm, params, max_len=64).beam_search_batch(
        prompts, num_beams, 10, eos)
    got = Decoder(model, max_len=64).beam_search_batch(prompts, num_beams, 10,
                                                       eos)
    for (ws, wsc, wn), (gs, gsc, gn) in zip(want, got):
        assert gs == ws
        np.testing.assert_allclose(gsc, wsc, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gn, wn, rtol=1e-5, atol=1e-5)
        assert list(gsc) == sorted(gsc, reverse=True)
    if with_eos and num_beams == 3:
        assert any(len(s) < 10 and s[-1] == eos for g in got for s in g[0])
    assert Decoder(model, max_len=64).beam_search(
        prompts[2], num_beams, 10, eos)[0] == want[2][0]


def test_beam_ties_break_lowest_index_first(beam_pair):
    """Equal scores keep lax.top_k's order: with all weights 0 every logit
    is equal, and both decoders keep the lowest (beam, token) index: beam 0
    extended by tokens 0, 1 and 2 at every step."""
    jm, params, _, _, _ = beam_pair
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    want = JDecoder(jm, zeros, max_len=64).beam_search([1, 5, 9], 3, 4)
    got = Decoder(ported(zeros, **BEAM), max_len=64).beam_search([1, 5, 9], 3, 4)
    assert got[0] == want[0] == [[0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 2]]
    np.testing.assert_allclose(got[2], 1 / 3)


@pytest.mark.parametrize("n_kv_heads,safe", [(2, True), (4, False)])
def test_load_hf_llama_matches_hf_and_jax(tmp_path, n_kv_heads, safe):
    """A tiny HF LlamaForCausalLM saved as safetensors (GQA 2:1) or as
    pytorch_model.bin, read without transformers into the port's LlamaLM."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=n_kv_heads,
        intermediate_size=64, max_position_embeddings=128,
        tie_word_embeddings=False, bos_token_id=1, eos_token_id=2,
        pad_token_id=0)
    torch.manual_seed(3)
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    hf.save_pretrained(tmp_path, safe_serialization=safe)
    assert os.path.exists(tmp_path / ("model.safetensors" if safe
                                      else "pytorch_model.bin"))
    state, cfg = load_hf_llama(str(tmp_path))
    jparams, jcfg = jload_hf_llama(str(tmp_path))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = LlamaLM(cfg)
    model.load_state_dict(state)
    model.eval()
    tokens = np.random.default_rng(4).integers(3, 64, (2, 11))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))[0].numpy()
        want_hf = hf(torch.from_numpy(tokens)).logits.numpy()
    jm = JLlamaLM(dataclasses.replace(jcfg, dtype="float32"))
    want_jax = np.asarray(jm.apply(jparams, jnp.asarray(tokens, jnp.int32))[0])
    for want in (want_hf, want_jax):
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    prompt = [1, 30, 31, 32, 33]
    seqs, scores, _ = Decoder(model, max_len=64).beam_search(
        prompt, num_beams=3, max_new_tokens=8, eos_id=2)
    with torch.no_grad():
        ref = hf.generate(torch.tensor([prompt]), max_new_tokens=8, num_beams=3,
                          num_return_sequences=3, do_sample=False,
                          output_scores=True, return_dict_in_generate=True,
                          pad_token_id=0, eos_token_id=2)
    ref_seqs = [r.tolist()[len(prompt):] for r in ref.sequences]
    ref_seqs = [s[: s.index(2) + 1] if 2 in s else s for s in ref_seqs]
    assert seqs == ref_seqs
    np.testing.assert_allclose(scores, ref.sequences_scores.numpy(), rtol=2e-4,
                               atol=2e-4)
