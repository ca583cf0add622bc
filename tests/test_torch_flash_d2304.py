"""Float32 at head dims 2176 and 2304 in the LLM reader against the JAX
package on the CPU.

Past 2048 the float32 flash kernels cannot take one 128-column block of
the head row a block: sixteen blocks is Hopper's largest thread block
cluster. At 2176 and 2304 they run on NB = ceil(D / 192) blocks, twelve,
each on a share of whole 64-column boxes of at most three, the shares
differing by at most one box, the wider first (``split3_shares``: 12 x 192
at 2304, 10 x 192 + 2 x 128 at 2176; csrc/flash_attention.cu,
``flash_*_shares3_kernel<192>``), on 64 query rows (keys for dk/dv) a
block with 32-key forward tiles and 16-key (dq) and 16-row (dk/dv)
backward tiles; the blocks' partial scores are added in rank order. The
JAX reader sends these head dims to its Pallas kernels
(gnn_rag_tpu/llm_tpu/model.py:199-200), whose float32 ceiling is about
2,304; chip_smoke.py's step-time-llm-d2304-fp32 phase runs Gemma-2-2B's
width (dim 2304) with its query columns as one float32 head of 2304. Held
here to the JAX package on the same numpy inputs:

* the plain flash versions (what a CPU tensor runs, and the card check's
  yardstick) vs the Pallas kernels in interpret mode at B1 L256 H1, D 2176
  and 2304: o and lse to 2e-4, dq, dk and dv to 5e-4, relative and
  absolute (tests/test_torch_flash_d1024.py's: the two sum in other
  orders);
* ``split3_shares`` at every float32 head dim from 1152 to 2304: an exact
  cover by whole boxes, at most three a block and at most 16 blocks, the
  shares within one box of each other, the wider first;
* the new kernels' arithmetic emulated at 2176 and 2304 (each float as
  three bf16 terms, six products a product, tests/
  test_torch_flash_split3.py's helpers; the twelve blocks' partial scores
  over their box shares added in rank order; the forward's online softmax
  over 32-key tiles, dq's 16-key and dk/dv's 16-row tiles), at B1 L160
  H1: o, lse, dq, dk and dv within a quarter of the card tolerance (1e-4
  of max|plain|) of the function in float64; the twelve-partial sum within
  float rounding of the float64 score and unequal on some element to the
  reverse order's;
* ``flash_applies``: float32 on the card takes 2176 and 2304 but not
  2432, the 16-bit head dims are as they were (to 4096);
* a tied float32 LlamaLM at head dim 2304 (dim 2304, one head, one kv
  head, one layer, small vocabulary and intermediate): logits 1e-4 of
  max|logit| against flax, three float32 SFT steps against the JAX
  trainer.

The emulations run on one torch thread (a fixture, as
tests/test_torch_flash_split3.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_flash_split3 as split3
from gnn_rag_tpu.llm_tpu import flash_attention as jfa
from gnn_rag_tpu.llm_tpu.model import LlamaConfig as JLlamaConfig
from gnn_rag_tpu.llm_tpu.model import LlamaLM as JLlamaLM
from gnn_rag_tpu.llm_tpu.sft import SFTConfig as JSFTConfig
from gnn_rag_tpu.llm_tpu.sft import SFTTrainer as JSFTTrainer
from gnn_rag_tpu_torch import bridge
from gnn_rag_tpu_torch.llm import flash_attention as fa
from gnn_rag_tpu_torch.llm.model import LlamaConfig, LlamaLM, flash_applies
from gnn_rag_tpu_torch.llm.sft import SFTConfig, SFTTrainer
from test_torch_flash_d4096 import assert_close, exact_backward, one_thread  # noqa: F401
from test_torch_flash_d512 import inputs, to_jax, to_torch

# one float32 head of 2304 with one kv head, tied embeddings, at a CPU width
NARROW = dict(vocab_size=300, dim=2304, n_layers=1, n_heads=1, n_kv_heads=1,
              intermediate=384, max_seq_len=256, dtype="float32",
              tie_embeddings=True)
EMULATED = (1, 160, 1)          # B, L, H of the emulations; then D
FWD_KEYS, DQ_KEYS, DKV_ROWS = 32, 16, 16     # the new kernels' tiles
# the float32 SFT test's Adam noise share (tests/test_torch_flash_d1024.py's
# NOISE): tests/test_torch_flash_d4096.py's, whose head-dim-2048 model
# needed 2.97e-3 at its third step; twice that
NOISE = 5.9e-3


# ------------------------------------------- plain versions against Pallas
@pytest.mark.parametrize("D", [2176, 2304])
def test_flash_fwd_plain_matches_pallas_interpret_d2304(D):
    q, k, v = inputs(0, (1, 256, 1, D), 3, "float32")
    jo, jlse = jfa._flash_fwd_impl(to_jax(q), to_jax(k), to_jax(v),
                                   interpret=True)
    o, lse = fa.flash_fwd(q, k, v)                # CPU: the plain version
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert_close(o, to_torch(jo, q.dtype), 2e-4)
    assert_close(lse, to_torch(jlse, torch.float32), 2e-4)


@pytest.mark.parametrize("D", [2176, 2304])
def test_flash_bwd_plain_matches_pallas_interpret_d2304(D):
    q, k, v, g = inputs(1, (1, 256, 1, D), 4, "float32")
    jo, jlse = jfa._flash_fwd_impl(to_jax(q), to_jax(k), to_jax(v),
                                   interpret=True)
    want = jfa._flash_bwd_impl(to_jax(q), to_jax(k), to_jax(v), jo, jlse,
                               to_jax(g), interpret=True)
    o, lse = to_torch(jo, q.dtype), to_torch(jlse, torch.float32)
    delta = fa.bwd_delta(o, g)
    got = (fa.flash_dq(q, k, v, g, lse, delta),
           *fa.flash_dkv(q, k, v, g, lse, delta))
    for a, b in zip(got, want):
        assert_close(a, to_torch(b, q.dtype), 5e-4)


@pytest.mark.parametrize("D", [2176, 2304])
def test_flash_plain_versions_in_float64_at_d2304(D):
    """The plain versions take the new head dims in float64 too (the card
    check's exact yardstick): float64 out, within float32 rounding of the
    float32 ones."""
    q, k, v, g = (x.double() for x in inputs(2, (1, 96, 1, D), 4, "float32"))
    o, lse = fa.flash_fwd_plain(q, k, v)
    delta = fa.bwd_delta(o, g).double()
    got = (o, lse, fa.flash_dq_plain(q, k, v, g, lse, delta),
           *fa.flash_dkv_plain(q, k, v, g, lse, delta))
    q32, k32, v32, g32 = (x.float() for x in (q, k, v, g))
    o32, lse32 = fa.flash_fwd_plain(q32, k32, v32)
    want = (o32, lse32,
            fa.flash_dq_plain(q32, k32, v32, g32, lse.float(), delta.float()),
            *fa.flash_dkv_plain(q32, k32, v32, g32, lse.float(),
                                delta.float()))
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and torch.isfinite(a).all()
        assert_close(a.float(), b, 1e-5)


# -------------------------------------------------------------- the shares
def test_split3_shares_cover_every_head_dim_on_at_most_sixteen_blocks():
    """ceil(D / 192) blocks of whole 64-column boxes, at most three, the
    shares within one box of each other, the wider first, covering the row,
    at every float32 head dim from 1152 to 2304 (the kernels take 2176 and
    2304 this way; 1152-2048 keep their 128-column blocks)."""
    for D in range(1152, 2305, 128):
        shares = fa.split3_shares(D)
        assert len(shares) == -(-D // 192) <= 16, D
        assert sum(shares) == D and all(s % 64 == 0 and 64 <= s <= 192
                                        for s in shares), D
        assert max(shares) - min(shares) <= 64, D
        assert shares == sorted(shares, reverse=True), D
    assert fa.split3_shares(2304) == [192] * 12
    assert fa.split3_shares(2176) == [192] * 10 + [128] * 2
    assert fa.split3_shares(2048) == [192] * 10 + [128]


# ---------------------------------------------- the kernels, emulated
def share_partials(eq, x, y):
    """The cluster's partial scores of a score product in rank order: six
    term products over block r's share of the depth from zero, summed in
    float32."""
    parts, c = [], 0
    for width in fa.split3_shares(x.shape[-1]):
        parts.append(split3.product(eq, x[..., c:c + width],
                                    y[..., c:c + width]))
        c += width
    return parts


def share_scores(eq, x, y):
    """A score product as the kernels form it: the partials added in rank
    order, ((p0 + p1) + p2) + .. + p11."""
    parts = share_partials(eq, x, y)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def forward_shares3(q, k, v):
    """(o, lse): s = q k^T from the shares' partials, the online softmax
    over 32-key tiles, o += p v as six term products a tile."""
    B, L, H, D = q.shape
    s = share_scores("blhd,bshd->bhls", q, k) / math.sqrt(D)
    keep = torch.arange(L)[None, :] <= torch.arange(L)[:, None]
    s = s.masked_fill(~keep, fa.NEG_INF)
    m = torch.full((B, H, L, 1), fa.NEG_INF)
    l = torch.zeros((B, H, L, 1))
    o = torch.zeros((B, H, L, D))
    for k0 in range(0, L, FWD_KEYS):
        st = s[..., k0:k0 + FWD_KEYS]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + split3.product("bhls,bshd->bhld", p,
                                       v[:, k0:k0 + FWD_KEYS])
        m = m_new
    return (o.transpose(1, 2) / l.transpose(1, 2),
            (m + torch.log(l)).reshape(B * H, L))


def dq_shares3(q, k, v, dout, lse, delta):
    """dq: s and dp from the shares' partials, dq += ds k over 16-key
    tiles."""
    B, L, H, D = q.shape
    scale = 1 / math.sqrt(D)
    s = share_scores("blhd,bshd->bhls", q, k) * scale
    keep = torch.arange(L)[None, :] <= torch.arange(L)[:, None]
    p = torch.exp(s - lse.reshape(B, H, L, 1)) * keep
    dp = share_scores("blhd,bshd->bhls", dout, v)
    ds = p * (dp - delta.reshape(B, H, L, 1)) * scale
    return split3.tiled("bhls,bshd->blhd", ds, k, 3, 1, DQ_KEYS, [])


def dkv_shares3(q, k, v, dout, lse, delta):
    """(dk, dv): s^T = k q^T and dp^T = v dO^T from the shares' partials,
    dv += p^T dO and dk += ds^T q over 16-row tiles."""
    B, L, H, D = q.shape
    scale = 1 / math.sqrt(D)
    st = share_scores("bshd,blhd->bhsl", k, q) * scale
    keep = torch.arange(L)[:, None] <= torch.arange(L)[None, :]
    pt = torch.exp(st - lse.reshape(B, H, 1, L)) * keep
    dpt = share_scores("bshd,blhd->bhsl", v, dout)
    dst = pt * (dpt - delta.reshape(B, H, 1, L)) * scale
    return (split3.tiled("bhsl,blhd->bshd", dst, q, 3, 1, DKV_ROWS, []),
            split3.tiled("bhsl,blhd->bshd", pt, dout, 3, 1, DKV_ROWS, []))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("D", [2176, 2304])
def test_shares3_arithmetic_within_a_quarter_of_the_tolerance(D):
    """The twelve-block clusters on 192-column shares, emulated: o and lse
    (forward), dq and dk, dv (the backward from the plain forward's lse and
    delta) within 0.25 x 1e-4 of max|plain| (the card check's tolerance)
    of the function in float64."""
    q, k, v, g = inputs(5, (*EMULATED, D), 4, "float32")
    po, plse = fa.flash_fwd_plain(q, k, v)
    delta = fa.bwd_delta(po, g)
    o, lse = forward_shares3(q, k, v)
    dq = dq_shares3(q, k, v, g, plse, delta)
    dk, dv = dkv_shares3(q, k, v, g, plse, delta)
    o64, lse64 = fa.flash_fwd_plain(q.double(), k.double(), v.double())
    plain = (po, plse, fa.flash_dq_plain(q, k, v, g, plse, delta),
             *fa.flash_dkv_plain(q, k, v, g, plse, delta))
    exact = (o64, lse64, *exact_backward(q, k, v, g, plse, delta))
    for name, a, x, r in zip(("o", "lse", "dq", "dk", "dv"),
                             (o, lse, dq, dk, dv), exact, plain):
        assert a.shape == x.shape and a.dtype == torch.float32, name
        err = (a.double() - x).abs().max().item() / (
            1e-4 * r.abs().max().item())
        assert err <= 0.25, (name, err)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("D", [2176, 2304])
def test_twelve_share_partials_sum_in_rank_order(D):
    """A score q k^T of a cluster of twelve blocks, the rank-order float
    sum of the blocks' float partials over their box shares, is the float64
    product to within the six products' 2^-21 of the sum of its terms'
    sizes plus one rounding of each partial and each add, and the reverse
    order's sum of the same partials differs from it on some element:
    every block must add them alike."""
    q, k = inputs(9, (*EMULATED, D), 2, "float32")
    eq = "blhd,bshd->bhls"
    exact = torch.einsum(eq, q.double(), k.double())
    size = torch.einsum(eq, q.double().abs(), k.double().abs())
    parts = share_partials(eq, q, k)
    assert len(parts) == 12
    s = share_scores(eq, q, k)
    rounding = 2.0 ** -24 * (2 * len(parts) - 1) * sum(
        p.double().abs() for p in parts)
    assert bool(((s.double() - exact).abs()
                 <= 2.0 ** -21 * size + rounding).all())
    reverse = parts[-1]
    for part in parts[-2::-1]:
        reverse = reverse + part
    assert not torch.equal(s, reverse)


# --------------------------------------------------------------- the rule
@pytest.mark.parametrize("head_dim,dtype,device,want", [
    (2176, torch.float32, "cuda", True),      # twelve blocks of 192 / 128
    (2304, torch.float32, "cuda", True),      # twelve of 192
    (2048, torch.float32, "cuda", True),      # sixteen of 128, as before
    (2432, torch.float32, "cuda", False),     # past JAX's float32 ceiling
    (2304, torch.bfloat16, "cuda", True),     # 16 bits unchanged: to 4096
    (4096, torch.float16, "cuda", True),
    (4224, torch.bfloat16, "cuda", False),
    (2304, torch.float32, "cpu", False)])
def test_flash_rule_takes_float32_to_head_dim_2304(head_dim, dtype, device,
                                                   want):
    assert flash_applies(True, head_dim, dtype, device, False, False) is want
    assert not flash_applies(True, head_dim, dtype, device, True, False)
    assert not flash_applies(True, head_dim, dtype, device, False, True)
    assert (head_dim in fa.HEAD_DIMS[dtype]) is (want or device == "cpu")


# ----------------------------------------------------- LlamaLM and the SFT
@pytest.fixture(scope="module")
def narrow():
    """A tied flax float32 LlamaLM at head dim 2304 with one kv head, and
    its params."""
    tokens = np.random.default_rng(5).integers(3, 300, (2, 40)).astype(np.int32)
    jm = JLlamaLM(JLlamaConfig(**NARROW))
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(tokens[:, :8]))
    return tokens, params


def test_llama_d2304_fp32_logits_match_flax(narrow):
    tokens, params = narrow
    cfg = LlamaConfig(**NARROW)
    assert cfg.head_dim == 2304 and cfg.n_kv_heads == 1 and cfg.tie_embeddings
    want, _ = JLlamaLM(JLlamaConfig(**NARROW)).apply(params,
                                                     jnp.asarray(tokens))
    state = bridge.llama_from_flax(params)
    assert not any(name.startswith("lm_head") for name in state)
    model = LlamaLM(cfg)
    model.load_state_dict(state)
    with torch.no_grad():
        got, _ = model.eval()(torch.from_numpy(tokens).long())
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_sft_d2304_fp32_three_steps_match_jax(narrow, tmp_path):
    """Three float32 SFTTrainer steps of the head-dim-2304 model from the
    same weights and batches (clip 0.5, weight decay 0.01, warmup and
    cosine): losses (rtol 1e-5) and every parameter after each step agree
    with the JAX trainer's (as tests/test_torch_flash_d4096.py holds head
    dim 2048)."""
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
