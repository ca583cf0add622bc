"""Head dim 256 in the LLM reader against the JAX package on the CPU.

The port's flash kernels take head dim 256 in float32 and bfloat16 on the
card; their plain versions (what a CPU tensor runs, and the card check's
yardstick) and a LlamaLM at Gemma-2B's head dim are held here to the JAX
package on the same numpy inputs. Tolerances:

* plain flash versions vs the Pallas kernels in interpret mode (B1 L256 H2
  D256): float32 o and lse 2e-4, dq/dk/dv 5e-4 (the D 128 test's: the two
  sum in other orders); bfloat16 outputs per element to ``bf16_tol`` (one
  bf16 step, 1e-2 of the row's rms, 1e-3 of the tensor's rms), lse 2e-4;
  the backward runs from JAX's o and lse on both sides;
* LlamaLM at head dim 256 (dim 512, 2 heads, 1 kv head, tied embeddings, 2
  layers): logits float32 1e-4 and bfloat16 2e-2 of max|logit|;
* three float32 SFT steps: each loss rtol 1e-5, parameters rtol 1e-4 +
  atol 1e-6 plus Adam's share of float32 gradient noise (see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rag_tpu.llm_tpu import flash_attention as jfa
from gnn_rag_tpu.llm_tpu.model import LlamaConfig as JLlamaConfig
from gnn_rag_tpu.llm_tpu.model import LlamaLM as JLlamaLM
from gnn_rag_tpu.llm_tpu.sft import SFTConfig as JSFTConfig
from gnn_rag_tpu.llm_tpu.sft import SFTTrainer as JSFTTrainer
from gnn_rag_tpu_torch import bridge
from gnn_rag_tpu_torch.llm import flash_attention as fa
from gnn_rag_tpu_torch.llm.model import LlamaConfig, LlamaLM
from gnn_rag_tpu_torch.llm.sft import SFTConfig, SFTTrainer

SHAPE = (1, 256, 2, 256)          # B, L, H, D
NARROW = dict(vocab_size=300, dim=512, n_layers=2, n_heads=2, n_kv_heads=1,
              intermediate=384, max_seq_len=256, tie_embeddings=True)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def inputs(seed, n, dtype):
    """n [B, L, H, D] arrays from a numpy seed: (jax, torch) pairs, both
    rounded to ``dtype`` the same way (through torch)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
        x = x.to(getattr(torch, dtype))
        out.append((jnp.asarray(x.float().numpy()).astype(JNP[dtype]), x))
    return out


def to_torch(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(
        getattr(torch, dtype))


def bf16_tol(b):
    """One bf16 step of |b| + 1e-2 rms over the last axis + 1e-3 rms(b)."""
    sq = b.float().square()
    return (2 ** -7 * sq.sqrt() + 1e-2 * sq.mean(-1, keepdim=True).sqrt()
            + 1e-3 * sq.mean().sqrt())


def assert_close(got, want, dtype, tol, name):
    """float32 (and lse): ``tol`` absolute and relative; bfloat16 outputs per
    element to ``bf16_tol``."""
    assert got.dtype == want.dtype, name
    if want.dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol,
                                   atol=tol, err_msg=name)
        return
    ratio = ((got.float() - want.float()).abs() / bf16_tol(want)).max().item()
    assert ratio <= 1, (name, dtype, ratio)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_plain_matches_pallas_interpret_d256(dtype):
    (jq, q), (jk, k), (jv, v) = inputs(0, 3, dtype)
    jo, jlse = jfa._flash_fwd_impl(jq, jk, jv, interpret=True)
    o, lse = fa.flash_fwd(q, k, v)                # CPU: the plain version
    assert o.dtype == q.dtype and lse.shape == (2, 256)
    assert_close(o, to_torch(jo, dtype), dtype, 2e-4, "o")
    assert_close(lse, to_torch(jlse, "float32"), dtype, 2e-4, "lse")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_plain_matches_pallas_interpret_d256(dtype):
    (jq, q), (jk, k), (jv, v), (jg, g) = inputs(1, 4, dtype)
    jo, jlse = jfa._flash_fwd_impl(jq, jk, jv, interpret=True)
    want = jfa._flash_bwd_impl(jq, jk, jv, jo, jlse, jg, interpret=True)
    o, lse = to_torch(jo, dtype), to_torch(jlse, "float32")
    delta = fa.bwd_delta(o, g)
    got = (fa.flash_dq(q, k, v, g, lse, delta),
           *fa.flash_dkv(q, k, v, g, lse, delta))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert_close(a, to_torch(b, dtype), dtype, 5e-4, name)
    # the autograd op's CPU path gives the same gradients as the plain
    # backward from its own forward
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    fa.flash_attention(tq, tk, tv).backward(g)
    po, plse = fa.flash_fwd_plain(q, k, v)
    plain = fa.flash_bwd(q, k, v, po, plse, g)
    for name, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.fixture(scope="module")
def narrow():
    """A flax LlamaLM at head dim 256 (GQA 2:1, tied) and its params."""
    tokens = np.random.default_rng(5).integers(3, 300, (2, 40)).astype(np.int32)
    jm = JLlamaLM(JLlamaConfig(**NARROW, dtype="float32"))
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(tokens[:, :8]))
    return tokens, params


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_llama_d256_logits_match_flax(narrow, dtype, tol):
    tokens, params = narrow
    cfg = LlamaConfig(**NARROW, dtype=dtype)
    assert cfg.head_dim == 256
    want, _ = JLlamaLM(JLlamaConfig(**NARROW, dtype=dtype)).apply(
        params, jnp.asarray(tokens))
    model = LlamaLM(cfg)
    model.load_state_dict(bridge.llama_from_flax(params))
    with torch.no_grad():
        got, _ = model.eval()(torch.from_numpy(tokens).long())
    want = np.asarray(want)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_sft_d256_three_steps_match_jax(narrow, tmp_path):
    """Three SFTTrainer steps of the head-dim-256 model from the same
    weights and batches (clip 0.5, weight decay 0.01, warmup and cosine):
    losses and every parameter after each step agree with the JAX
    trainer's."""
    _, params = narrow
    rng = np.random.default_rng(6)
    tokens = rng.integers(3, 300, (6, 33)).astype(np.int32)
    mask = (rng.random((6, 33)) < 0.6).astype(np.float32)
    kw = dict(learning_rate=1e-3, weight_decay=0.01, warmup_steps=1,
              total_steps=3, batch_size=4, grad_clip=0.5, save_every=1000)
    jtr = JSFTTrainer(JLlamaConfig(**NARROW, dtype="float32"),
                      JSFTConfig(output_dir=str(tmp_path / "j"), **kw),
                      params=jax.tree_util.tree_map(jnp.array, params))
    tr = SFTTrainer(LlamaConfig(**NARROW, dtype="float32"),
                    SFTConfig(output_dir=str(tmp_path / "t"), **kw),
                    params=bridge.llama_from_flax(params), device="cpu")
    lr = kw["learning_rate"]
    for step in (1, 2, 3):
        jloss = jtr.train(tokens, mask, steps=step, resume=False)
        loss = tr.train(tokens, mask, steps=step, resume=False)
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        want = bridge.llama_from_flax(jtr.params)
        for name, p in tr.model.named_parameters():
            # Adam divides a gradient by its RMS, so the float32 noise of the
            # two frameworks' gradients (sums of ~1e4 terms in other orders:
            # ~1e-5 of the tensor's largest) moves an element by up to lr x
            # that noise / its own RMS a step: held to rtol 1e-4 + atol 1e-6
            # plus 3 lr x min(1, 1e-5 max(rms) / rms)
            rms = (tr.opt.state[p]["exp_avg_sq"] / (1 - 0.999 ** step)
                   ).sqrt().numpy()
            noise = 3 * lr * np.minimum(
                1.0, 1e-5 * rms.max() / np.maximum(rms, 1e-30))
            got, ref = p.detach().numpy(), want[name].numpy()
            excess = np.abs(got - ref) - (1e-4 * np.abs(ref) + 1e-6 + noise)
            assert excess.max() <= 0, (name, step, excess.max())
    assert tr.step == jtr.step == 3
