"""Head dims 640 to 1024 in float32 in the LLM reader against the JAX package
on the CPU.

The port's float32 flash kernels take head dims 640, 768, 896 and 1024 on
the card, each as a cluster of D / 128 blocks (five to eight), each on 128
columns, whose partial scores are added rank by rank in rank order
(csrc/flash_attention.cu, ``flash_*_split3_kernel<640|..|1024>``; their
arithmetic is emulated in tests/test_torch_flash_split3.py). Their plain
versions (what a CPU tensor runs, and the card check's yardstick), the
flash rule and a LlamaLM with heads of 1024 and one kv head (LLaMA-2-7B's
query columns regrouped, as chip_smoke.py's step-time-llm-d1024-fp32 phase
runs it) are held here to the JAX package on the same numpy inputs:

* plain flash versions vs the Pallas kernels in interpret mode (B1 L256
  H2, D 640 and 1024, float32: the Pallas kernels at Precision.HIGHEST): o
  and lse to 2e-4, dq, dk and dv to 5e-4, relative and absolute (the
  head-dim-256 and 512 tests': the two sum in other orders);
* ``flash_applies``: the kernels in every type at 640-1024 on the card
  (bfloat16 and float16 in clusters of three and four blocks,
  tests/test_torch_flash_d1024_16.py), float32 not at 2432, bfloat16 and
  float16 not at 4224 (the first head dims the kernels refuse: float32
  past twelve blocks of 192 columns, tests/test_torch_flash_d2304.py, 16
  bits past sixteen of 256, tests/test_torch_flash_d4096.py), not on the
  CPU;
* LlamaLM at head dim 1024 (dim 2048, 2 heads, 1 kv head, 2 layers,
  float32): logits 1e-4 of max|logit|;
* three float32 SFT steps: each loss rtol 1e-5 (as at head dims 256 and
  512; measured 8.2e-7), parameters rtol 1e-4 + atol 1e-6 plus Adam's
  share of the gradient noise (``NOISE``, see the test).
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
from gnn_rag_tpu_torch.llm.model import LlamaConfig, LlamaLM, flash_applies
from gnn_rag_tpu_torch.llm.sft import SFTConfig, SFTTrainer

# head dim 1024 and one kv head at a CPU width
NARROW = dict(vocab_size=300, dim=2048, n_layers=2, n_heads=2, n_kv_heads=1,
              intermediate=384, max_seq_len=256, dtype="float32")
# the two frameworks' float32 gradient noise after the parameters drifted
# apart, as a share of a tensor's largest gradient RMS (sums of ~1e4 terms
# in other orders), measured as tests/test_torch_flash_d512.py measures it
# at head dim 512: 6.4e-8 at the second step and 3.5e-4 at the third here,
# twice the larger
NOISE = 7.1e-4


def inputs(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(n)]


def to_jax(x):
    return jnp.asarray(x.numpy())


def to_torch(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def assert_close(got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    err = ((got - want).abs() / (tol * (1 + want.abs()))).max().item()
    assert err <= 1, err


# ------------------------------------------- plain versions against Pallas
@pytest.mark.parametrize("D", [640, 1024])
def test_flash_fwd_plain_matches_pallas_interpret_d1024(D):
    q, k, v = inputs(0, (1, 256, 2, D), 3)
    jo, jlse = jfa._flash_fwd_impl(to_jax(q), to_jax(k), to_jax(v),
                                   interpret=True)
    o, lse = fa.flash_fwd(q, k, v)                # CPU: the plain version
    assert_close(o, to_torch(jo), 2e-4)
    assert_close(lse, to_torch(jlse), 2e-4)


@pytest.mark.parametrize("D", [640, 1024])
def test_flash_bwd_plain_matches_pallas_interpret_d1024(D):
    q, k, v, g = inputs(1, (1, 256, 2, D), 4)
    jo, jlse = jfa._flash_fwd_impl(to_jax(q), to_jax(k), to_jax(v),
                                   interpret=True)
    want = jfa._flash_bwd_impl(to_jax(q), to_jax(k), to_jax(v), jo, jlse,
                               to_jax(g), interpret=True)
    o, lse = to_torch(jo), to_torch(jlse)
    delta = fa.bwd_delta(o, g)
    got = (fa.flash_dq(q, k, v, g, lse, delta),
           *fa.flash_dkv(q, k, v, g, lse, delta))
    for a, b in zip(got, want):
        assert_close(a, to_torch(b), 5e-4)


# --------------------------------------------------------------- the rule
@pytest.mark.parametrize("head_dim,dtype,device,want", [
    (640, torch.float32, "cuda", True),       # clusters of five to eight
    (768, torch.float32, "cuda", True),
    (896, torch.float32, "cuda", True),
    (1024, torch.float32, "cuda", True),
    (640, torch.bfloat16, "cuda", True),      # the 16-bit types too
    (640, torch.float16, "cuda", True),
    (1024, torch.bfloat16, "cuda", True),
    (1024, torch.float16, "cuda", True),
    (2432, torch.float32, "cuda", False),     # past twelve of 192 columns
    (4224, torch.bfloat16, "cuda", False),    # 16-bit: past sixteen of 256
    (4224, torch.float16, "cuda", False),
    (1024, torch.float32, "cpu", False)])
def test_flash_rule_takes_float32_to_head_dim_1024(head_dim, dtype, device,
                                                   want):
    assert flash_applies(True, head_dim, dtype, device, False, False) is want
    assert not flash_applies(True, head_dim, dtype, device, True, False)
    assert not flash_applies(False, head_dim, dtype, device, False, False)
    assert (head_dim in fa.HEAD_DIMS[dtype]) is (want or device == "cpu")


# ----------------------------------------------------- LlamaLM and the SFT
@pytest.fixture(scope="module")
def narrow():
    """A flax LlamaLM at head dim 1024 with one kv head, and its params."""
    tokens = np.random.default_rng(5).integers(3, 300, (2, 40)).astype(np.int32)
    jm = JLlamaLM(JLlamaConfig(**NARROW))
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(tokens[:, :8]))
    return tokens, params


def test_llama_d1024_logits_match_flax(narrow):
    tokens, params = narrow
    cfg = LlamaConfig(**NARROW)
    assert cfg.head_dim == 1024 and cfg.n_kv_heads == 1
    want, _ = JLlamaLM(JLlamaConfig(**NARROW)).apply(params,
                                                     jnp.asarray(tokens))
    model = LlamaLM(cfg)
    model.load_state_dict(bridge.llama_from_flax(params))
    with torch.no_grad():
        got, _ = model.eval()(torch.from_numpy(tokens).long())
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_sft_d1024_three_steps_match_jax(narrow, tmp_path):
    """Three float32 SFTTrainer steps of the head-dim-1024 model from the
    same weights and batches (clip 0.5, weight decay 0.01, warmup and
    cosine): losses and every parameter after each step agree with the JAX
    trainer's."""
    _, params = narrow
    rng = np.random.default_rng(6)
    tokens = rng.integers(3, 300, (6, 33)).astype(np.int32)
    mask = (rng.random((6, 33)) < 0.6).astype(np.float32)
    kw = dict(learning_rate=1e-3, weight_decay=0.01, warmup_steps=1,
              total_steps=3, batch_size=4, grad_clip=0.5, save_every=1000)
    jtr = JSFTTrainer(JLlamaConfig(**NARROW),
                      JSFTConfig(output_dir=str(tmp_path / "j"), **kw),
                      params=jax.tree_util.tree_map(jnp.array, params))
    tr = SFTTrainer(LlamaConfig(**NARROW),
                    SFTConfig(output_dir=str(tmp_path / "t"), **kw),
                    params=bridge.llama_from_flax(params), device="cpu")
    lr = kw["learning_rate"]
    for step in (1, 2, 3):
        jloss = jtr.train(tokens, mask, steps=step, resume=False)
        loss = tr.train(tokens, mask, steps=step, resume=False)
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        want = bridge.llama_from_flax(jtr.params)
        for name, p in tr.model.named_parameters():
            # Adam divides a gradient by its RMS: the frameworks' gradient
            # noise moves an element by up to lr x that noise / its own RMS
            # a step (tests/test_torch_flash_d512.py)
            rms = (tr.opt.state[p]["exp_avg_sq"] / (1 - 0.999 ** step)
                   ).sqrt().numpy()
            noise = 3 * lr * np.minimum(
                1.0, NOISE * rms.max() / np.maximum(rms, 1e-30))
            got, ref = p.detach().numpy(), want[name].numpy()
            excess = np.abs(got - ref) - (1e-4 * np.abs(ref) + 1e-6 + noise)
            assert excess.max() <= 0, (name, step, excess.max())
    assert tr.step == jtr.step == 3
