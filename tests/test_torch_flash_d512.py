"""Head dims 384 and 512 in the LLM reader against the JAX package on the CPU.

The port's bfloat16 and float16 flash kernels take head dim 384 and 512 on
the card, each as a cluster of two blocks on half of the columns whose
partial scores are added once (csrc/flash_attention.cu, the
``flash_*_pair_kernel`` instances); the float32 ones as clusters of three
and four blocks, each on 128 columns, whose partial scores are added in
rank order (``flash_*_split3_kernel<384|512>``, emulated in
tests/test_torch_flash_split3.py). Their plain versions (what a CPU tensor
runs, and the card check's yardstick), an emulation of the pair's
arithmetic and a LlamaLM at DeepSeek-V4-Flash's attention head shape (head
dim 512, one kv head) are held here to the JAX package on the same numpy
inputs. Tolerances (``bf16_tol`` and ``f16_tol`` are the card check's
per-element tolerances, chip_smoke.attn_err):

* plain flash versions vs the Pallas kernels in interpret mode (B1 L256 H2,
  D 384 and 512): o, dq, dk and dv to ``bf16_tol`` / ``f16_tol``, lse to
  2e-4 (bfloat16) and 1e-5 (float16); float32 (the Pallas kernels at
  Precision.HIGHEST) o and lse to 2e-4, dq, dk and dv to 5e-4, relative and
  absolute (the head-dim-256 test's: the two sum in other orders); the
  backward from JAX's o and lse on both sides, float16 also with the
  cotangent x 2^-16;
* the pair kernels emulated (``KernelPair``: s and dp as the sums of two
  float partials over the two column halves, the forward's online softmax
  over 64-key tiles with p rounded to the input type, dq over 32-key
  tiles and dk/dv over 32-row tiles with p and ds as two 16-bit terms,
  float16 after the kernels' power-of-two scales) vs the plain versions at
  B1 L300 H2: dq, dk and dv in float within 0.1 of the card tolerance of
  their rounded values, lse within 1e-5, o (rounded, as the kernels store
  it) within the card tolerance: p rounds at another point of the online
  softmax than in the plain two-pass one, the same for every 16-bit
  kernel; and the pair's scores within D 2^-24 of the sum of their terms'
  sizes of the float64 product;
* LlamaLM at head dim 512 (dim 1024, 2 heads, 1 kv head, 2 layers): logits
  float32 1e-4, bfloat16 2e-2 and float16 5e-3 of max|logit|;
* three SFT steps in float32, bfloat16 and float16: each loss to
  ``LOSS_RTOL`` (float32 1e-5, as at head dim 256, against a measured
  1.2e-7; twice the measured
  8.6e-4 bfloat16 and 2.0e-4 float16, at the third step: the parameters
  have drifted apart by then, as below), parameters rtol 1e-4 + atol 1e-6
  plus Adam's share of the gradient noise (``NOISE``, see the test).
"""

import math

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

# head dim 512 and one kv head, DeepSeek-V4-Flash's attention head shape,
# at a CPU width
NARROW = dict(vocab_size=300, dim=1024, n_layers=2, n_heads=2, n_kv_heads=1,
              intermediate=384, max_seq_len=256)
# the two frameworks' gradient noise after the parameters drifted apart, as
# a share of a tensor's largest gradient RMS: the SFT test needs up to
# 0.0043 (bfloat16) and 7.4e-4 (float16) at the second step and 0.26 and
# 0.14 at the third, twice the larger; float32 (sums of ~1e4 terms in
# other orders) 7.9e-8 at the second and 1.3e-4 at the third, twice that
NOISE = {"float32": 2.6e-4, "bfloat16": 0.52, "float16": 0.28}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-3, "float16": 4e-4}


def bf16_tol(b):
    """One bf16 step of |b| + 1e-2 rms over the last axis + 1e-3 rms(b)."""
    sq = b.float().square()
    return (2 ** -7 * sq.sqrt() + 1e-2 * sq.mean(-1, keepdim=True).sqrt()
            + 1e-3 * sq.mean().sqrt())


def f16_tol(b):
    """One float16 step of |b| + 1.25e-3 rms over the last axis + 1.25e-4
    rms(b) + one subnormal step."""
    sq = b.float().square()
    return (2 ** -10 * sq.sqrt() + 1.25e-3 * sq.mean(-1, keepdim=True).sqrt()
            + 1.25e-4 * sq.mean().sqrt() + 2 ** -24)


def tol(b):
    return f16_tol(b) if b.dtype == torch.float16 else bf16_tol(b)


def ratio(got, want, f32_tol=2e-4):
    """Largest |got - want| over the card tolerance of ``want``; float32
    over ``f32_tol`` (1 + |want|), absolute and relative."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == torch.float32:
        return ((got - want).abs() / (f32_tol * (1 + want.abs()))).max().item()
    return ((got.float() - want.float()).abs() / tol(want)).max().item()


def inputs(seed, shape, n, dtype, g_scale=1.0):
    """n [B, L, H, D] tensors of ``dtype`` from a numpy seed, the last (the
    cotangent) times ``g_scale`` before its rounding."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    out[-1] = out[-1] * np.float32(g_scale)
    return [torch.from_numpy(x).to(getattr(torch, dtype)) for x in out]


def to_jax(x):
    return jnp.asarray(x.float().numpy()).astype(
        {torch.float32: jnp.float32, torch.float16: jnp.float16,
         torch.bfloat16: jnp.bfloat16}[x.dtype])


def to_torch(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dtype)


# ------------------------------------------- plain versions against Pallas
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("D", [384, 512])
def test_flash_fwd_plain_matches_pallas_interpret_d512(D, dtype):
    q, k, v = inputs(0, (1, 256, 2, D), 3, dtype)
    jo, jlse = jfa._flash_fwd_impl(to_jax(q), to_jax(k), to_jax(v),
                                   interpret=True)
    o, lse = fa.flash_fwd(q, k, v)                # CPU: the plain version
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert ratio(o, to_torch(jo, q.dtype)) <= 1
    lse_tol = 1e-5 if dtype == "float16" else 2e-4
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=lse_tol,
                               atol=lse_tol)


@pytest.mark.parametrize("dtype,g_scale", [("float32", 1.0),
                                           ("bfloat16", 1.0),
                                           ("float16", 1.0),
                                           ("float16", 2.0 ** -16)])
@pytest.mark.parametrize("D", [384, 512])
def test_flash_bwd_plain_matches_pallas_interpret_d512(D, dtype, g_scale):
    q, k, v, g = inputs(1, (1, 256, 2, D), 4, dtype, g_scale)
    jo, jlse = jfa._flash_fwd_impl(to_jax(q), to_jax(k), to_jax(v),
                                   interpret=True)
    want = jfa._flash_bwd_impl(to_jax(q), to_jax(k), to_jax(v), jo, jlse,
                               to_jax(g), interpret=True)
    o, lse = to_torch(jo, q.dtype), to_torch(jlse, torch.float32)
    delta = fa.bwd_delta(o, g)
    got = (fa.flash_dq(q, k, v, g, lse, delta),
           *fa.flash_dkv(q, k, v, g, lse, delta))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = to_torch(b, q.dtype)
        assert ratio(a, b, 5e-4) <= 1, (name, ratio(a, b, 5e-4))
        # the small cotangent's gradients are float16 subnormals, not zeros
        assert a.float().abs().max() > 0, name


# ----------------------------------------------- the pair kernels, emulated
def split16(x, dtype):
    """x (float32) as its two terms hi + mid of the 16-bit ``dtype``, each
    widened (rounding to nearest, subnormals kept, as cvt.rn)."""
    hi = x.to(dtype).float()
    return hi, (x - hi).to(dtype).float()


class KernelPair:
    """The 16-bit pair kernels' arithmetic on [B, L, H, D] tensors
    (csrc/flash_attention.cu, ``flash_{fwd,dq,dkv}_pair_kernel<T, HD>``):
    every score s = q k^T and dp = dO v^T as the sum of two float partials,
    each over one block's C = D / 2 columns, added once (both blocks of a
    cluster hold these bits: IEEE addition commutes); the forward's online
    softmax over 64-key tiles with p rounded to T; dq over 32-key tiles and
    dk/dv over 32-row query tiles with p (p^T) and ds (ds^T) as two terms of
    T, float16's after p^T x 2^14 and ds x 2^e per accumulator row (the row
    scale falls with the row's largest |ds| so far, and the accumulator is
    rescaled when it does), every scale undone at the store. Outputs in
    float, before the kernels' rounding at the store."""

    P_E, E0 = 14, 74
    FWD_KEYS, DQ_KEYS, DKV_ROWS = 64, 32, 32

    def __init__(self, D, dtype):
        self.D, self.C, self.dtype = D, D // 2, dtype

    def scores(self, a, b):
        C = self.C
        return (a[..., :C] @ b[..., :C].transpose(-1, -2)
                + a[..., C:] @ b[..., C:].transpose(-1, -2))

    def _mask(self, L):
        return torch.arange(L)[None, :] <= torch.arange(L)[:, None]

    def forward(self, q, k, v):
        B, L, H, D = q.shape
        qh, kh, vh = (x.float().transpose(1, 2) for x in (q, k, v))
        s = self.scores(qh, kh) / math.sqrt(D)
        s = s.masked_fill(~self._mask(L), fa.NEG_INF)
        m = torch.full((B, H, L, 1), fa.NEG_INF)
        l = torch.zeros((B, H, L, 1))
        acc = torch.zeros((B, H, L, D))
        for k0 in range(0, L, self.FWD_KEYS):
            st = s[..., k0:k0 + self.FWD_KEYS]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(st - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = (acc * alpha + p.to(self.dtype).float()
                   @ vh[:, :, k0:k0 + self.FWD_KEYS])
            m = m_new
        l = l.clamp_min(1e-30)
        return (acc / l).transpose(1, 2), (m + torch.log(l)).reshape(B * H, L)

    def _row_scales(self, ds, e):
        """(ds x 2^e_new, e_new, 2^(e_new - e)) of one tile, rows on axis
        -2 (float16; bfloat16 keeps ds unscaled)."""
        if self.dtype != torch.float16:
            return ds, e, torch.ones_like(ds[..., :1])
        mx = ds.abs().amax(-1, keepdim=True).clamp(2.0 ** -60, 2.0 ** 60)
        e_new = torch.minimum(e, 14 - (torch.frexp(mx)[1] - 1))
        return (ds * torch.exp2(e_new.float()), e_new,
                torch.exp2((e_new - e).float()))

    def _terms(self, q, k, v, dout, lse, delta):
        B, L, H, D = q.shape
        qh, kh, vh, gh = (x.float().transpose(1, 2) for x in (q, k, v, dout))
        s = self.scores(qh, kh) / math.sqrt(D)
        p = torch.exp(s - lse.reshape(B, H, L, 1)) * self._mask(L)
        dp = self.scores(gh, vh)
        ds = p * (dp - delta.reshape(B, H, L, 1)) / math.sqrt(D)
        return qh, kh, gh, p, ds

    def dq(self, q, k, v, dout, lse, delta):
        B, L, H, D = q.shape
        _, kh, _, _, ds = self._terms(q, k, v, dout, lse, delta)
        acc = torch.zeros((B, H, L, D))
        e = torch.full((B, H, L, 1), self.E0, dtype=torch.int32)
        for k0 in range(0, L, self.DQ_KEYS):
            scaled, e, rescale = self._row_scales(
                ds[..., k0:k0 + self.DQ_KEYS], e)
            hi, mid = split16(scaled, self.dtype)
            kt = kh[:, :, k0:k0 + self.DQ_KEYS]
            acc = acc * rescale + hi @ kt + mid @ kt
        if self.dtype == torch.float16:
            acc = acc * torch.exp2(-e.float())
        return acc.transpose(1, 2)

    def dkv(self, q, k, v, dout, lse, delta):
        B, L, H, D = q.shape
        qh, _, gh, p, ds = self._terms(q, k, v, dout, lse, delta)
        pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)  # [B, H, S, L]
        dk = torch.zeros((B, H, L, D))
        dv = torch.zeros((B, H, L, D))
        e = torch.full((B, H, L, 1), self.E0, dtype=torch.int32)
        p_scale = 2.0 ** self.P_E if self.dtype == torch.float16 else 1.0
        for q0 in range(0, L, self.DKV_ROWS):
            cols = slice(q0, q0 + self.DKV_ROWS)
            hi, mid = split16(pt[..., cols] * p_scale, self.dtype)
            dv = dv + hi @ gh[:, :, cols] + mid @ gh[:, :, cols]
            scaled, e, rescale = self._row_scales(dst[..., cols], e)
            hi, mid = split16(scaled, self.dtype)
            dk = dk * rescale + hi @ qh[:, :, cols] + mid @ qh[:, :, cols]
        if self.dtype == torch.float16:
            dk = dk * torch.exp2(-e.float())
        return dk.transpose(1, 2), (dv / p_scale).transpose(1, 2)


@pytest.mark.parametrize("dtype,g_scale", [
    ("bfloat16", 1.0), ("float16", 1.0), ("float16", 2.0 ** -16),
    ("float16", 2.0 ** 4)])
@pytest.mark.parametrize("D", [384, 512])
def test_pair_kernel_arithmetic_within_the_card_tolerance(D, dtype, g_scale):
    q, k, v, g = inputs(5, (1, 300, 2, D), 4, dtype, g_scale)
    kern = KernelPair(D, q.dtype)
    po, plse = fa.flash_fwd_plain(q, k, v)
    delta = fa.bwd_delta(po, g)
    o, lse = kern.forward(q, k, v)
    assert ratio(o.to(q.dtype), po) <= 1
    assert (lse - plse).abs().max().item() <= 1e-5
    got = (kern.dq(q, k, v, g, plse, delta),
           *kern.dkv(q, k, v, g, plse, delta))
    # the plain backward before its rounding, and rounded (the tolerance's
    # scale, as the card check holds the kernels' rounded outputs)
    p, ds = fa._dscores(q, k, v, g, plse, delta)
    exact = (torch.einsum("bhls,bshd->blhd", ds, k.float()),
             torch.einsum("bhls,blhd->bshd", ds, q.float()),
             torch.einsum("bhls,blhd->bshd", p, g.float()))
    rounded = (fa.flash_dq_plain(q, k, v, g, plse, delta),
               *fa.flash_dkv_plain(q, k, v, g, plse, delta))
    for name, a, x, r in zip(("dq", "dk", "dv"), got, exact, rounded):
        err = ((a - x).abs() / tol(r)).max().item()
        assert err <= 0.1, (name, err)
        if g_scale < 1:      # the plain gradients are nonzero float16 values
            assert r.float().abs().max() > 0, name


@pytest.mark.parametrize("D", [384, 512])
def test_pair_scores_within_float_rounding(D):
    """The sum of the two blocks' partial scores is the float product of the
    16-bit inputs to within the float rounding of a D-term sum: D 2^-24 of
    the sum of its terms' sizes, against the float64 product."""
    q, k = inputs(9, (1, 200, 2, D), 2, "bfloat16")
    qh, kh = (x.float().transpose(1, 2) for x in (q, k))
    s = KernelPair(D, q.dtype).scores(qh, kh)
    exact = qh.double() @ kh.double().transpose(-1, -2)
    size = qh.double().abs() @ kh.double().abs().transpose(-1, -2)
    assert bool(((s.double() - exact).abs() <= D * 2.0 ** -24 * size).all())


# ----------------------------------------------------- LlamaLM and the SFT
@pytest.fixture(scope="module")
def narrow():
    """A flax LlamaLM at head dim 512 with one kv head, and its params."""
    tokens = np.random.default_rng(5).integers(3, 300, (2, 40)).astype(np.int32)
    jm = JLlamaLM(JLlamaConfig(**NARROW, dtype="float32"))
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(tokens[:, :8]))
    return tokens, params


@pytest.mark.parametrize("dtype,tol_", [("float32", 1e-4), ("bfloat16", 2e-2),
                                        ("float16", 5e-3)])
def test_llama_d512_logits_match_flax(narrow, dtype, tol_):
    tokens, params = narrow
    cfg = LlamaConfig(**NARROW, dtype=dtype)
    assert cfg.head_dim == 512 and cfg.n_kv_heads == 1
    want, _ = JLlamaLM(JLlamaConfig(**NARROW, dtype=dtype)).apply(
        params, jnp.asarray(tokens))
    model = LlamaLM(cfg)
    model.load_state_dict(bridge.llama_from_flax(params))
    with torch.no_grad():
        got, _ = model.eval()(torch.from_numpy(tokens).long())
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol_ * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_sft_d512_three_steps_match_jax(narrow, dtype, tmp_path):
    """Three SFTTrainer steps of the head-dim-512 model from the same
    weights and batches (clip 0.5, weight decay 0.01, warmup and cosine):
    losses and every parameter after each step agree with the JAX
    trainer's."""
    _, params = narrow
    rng = np.random.default_rng(6)
    tokens = rng.integers(3, 300, (6, 33)).astype(np.int32)
    mask = (rng.random((6, 33)) < 0.6).astype(np.float32)
    kw = dict(learning_rate=1e-3, weight_decay=0.01, warmup_steps=1,
              total_steps=3, batch_size=4, grad_clip=0.5, save_every=1000)
    jtr = JSFTTrainer(JLlamaConfig(**NARROW, dtype=dtype),
                      JSFTConfig(output_dir=str(tmp_path / "j"), **kw),
                      params=jax.tree_util.tree_map(jnp.array, params))
    tr = SFTTrainer(LlamaConfig(**NARROW, dtype=dtype),
                    SFTConfig(output_dir=str(tmp_path / "t"), **kw),
                    params=bridge.llama_from_flax(params), device="cpu")
    lr = kw["learning_rate"]
    for step in (1, 2, 3):
        jloss = jtr.train(tokens, mask, steps=step, resume=False)
        loss = tr.train(tokens, mask, steps=step, resume=False)
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL[dtype])
        want = bridge.llama_from_flax(jtr.params)
        for name, p in tr.model.named_parameters():
            # Adam divides a gradient by its RMS, so the two frameworks'
            # gradient noise (sums in other orders, 16-bit activations
            # rounded at other points: ~NOISE of the tensor's largest) moves an
            # element by up to lr x that noise / its own RMS a step: held to
            # rtol 1e-4 + atol 1e-6 plus 3 lr x min(1, NOISE max(rms) / rms)
            rms = (tr.opt.state[p]["exp_avg_sq"] / (1 - 0.999 ** step)
                   ).sqrt().numpy()
            noise = 3 * lr * np.minimum(
                1.0, NOISE[dtype] * rms.max() / np.maximum(rms, 1e-30))
            got, ref = p.detach().numpy(), want[name].numpy()
            excess = np.abs(got - ref) - (1e-4 * np.abs(ref) + 1e-6 + noise)
            assert excess.max() <= 0, (name, step, excess.max())
    assert tr.step == jtr.step == 3
