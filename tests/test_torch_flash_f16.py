"""Float16 in the LLM reader against the JAX package on the CPU.

The port's flash kernels take float16 at head dim 128 and 256 on the card;
their plain versions (what a CPU tensor runs, and the card check's
yardstick), an emulation of the float16 kernels' arithmetic, a float16
LlamaLM and three float16 SFT steps are held here to the JAX package on the
same numpy inputs. ``f16_tol(b)`` is the card check's per-element
tolerance of a float16 output (chip_smoke.f16_tol): one float16 step
(2^-10 |b|) + 1.25e-3 rms over the row's D values + 1.25e-4 rms(b) + 2^-24
(one subnormal step), bf16's form scaled by float16's step. Tolerances:

* plain flash versions vs the Pallas kernels in interpret mode (B1 L256 H2,
  D 128 and 256): o, dq, dk and dv to ``f16_tol``, lse to 1e-5 (absolute
  and relative: both sum the same float scores in other orders); the
  backward from JAX's o and lse on both sides, with an ordinary cotangent
  and with it x 2^-16 (dO mostly float16 subnormals);
* the float16 kernels emulated (``KernelF16``: the kernels' tiles, p
  rounded to float16 per key tile of the online softmax, p and ds as two
  float16 terms after the kernels' power-of-two scales) vs the plain
  versions at B1 L300 H2: o, dq, dk and dv within ``f16_tol`` (two float
  sums of the same terms in other orders round to float16 up to one step
  apart), lse 1e-5, at cotangents x 1, x 2^-16 and x 2^4; the same
  emulation with the scales off (an unscaled split) loses the small
  cotangent's ds and fails that tolerance by more than 10x;
* LlamaLM in float16 (head dim 128: dim 256, 2 heads, 1 kv head; 256: dim
  512, 2 heads, 1 kv head, tied): logits within 5e-3 of max|logit|
  (measured 1.3e-3 at both: float16 rounds at the same places in both, the
  GEMMs accumulate in other orders, and each layer's activations round to
  2^-11);
* three float16 SFT steps: each loss rtol 1e-4 (measured up to 4.9e-5),
  parameters rtol 1e-4 + atol 1e-6 plus Adam's share of the float16
  gradient noise (``NOISE``, see the test).
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

# narrow float16 readers at each head dim the kernels take
NARROW = {128: dict(vocab_size=300, dim=256, n_layers=2, n_heads=2,
                    n_kv_heads=1, intermediate=384, max_seq_len=256),
          256: dict(vocab_size=300, dim=512, n_layers=2, n_heads=2,
                    n_kv_heads=1, intermediate=384, max_seq_len=256,
                    tie_embeddings=True)}
# cotangent scales: ordinary, far under float16's normal range, large
G_SCALES = (1.0, 2.0 ** -16, 2.0 ** 4)
# the two frameworks' float16 gradient noise after the parameters drifted
# apart, as a share of a tensor's largest gradient RMS: test_sft_f16_three_
# steps_match_jax needs up to 6e-4 at the second step and 0.051 at the
# third (both head dims); twice the larger
NOISE = 0.1


def f16_tol(b):
    """One float16 step of |b| + 1.25e-3 rms over the last axis + 1.25e-4
    rms(b) + one subnormal step (chip_smoke.f16_tol)."""
    sq = b.float().square()
    return (2 ** -10 * sq.sqrt() + 1.25e-3 * sq.mean(-1, keepdim=True).sqrt()
            + 1.25e-4 * sq.mean().sqrt() + 2 ** -24)


def ratio(got, want):
    """Largest |got - want| over ``f16_tol(want)``."""
    assert got.dtype == want.dtype == torch.float16 and got.shape == want.shape
    return ((got.float() - want.float()).abs() / f16_tol(want)).max().item()


def inputs(seed, shape, n, g_scale=1.0):
    """n float16 [B, L, H, D] tensors from a numpy seed, the last (the
    cotangent) times ``g_scale`` before its rounding to float16."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    out[-1] = out[-1] * np.float32(g_scale)
    return [torch.from_numpy(x).half() for x in out]


def to_jax(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.float16)


def to_torch(x, dtype=torch.float16):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dtype)


# ------------------------------------------- plain versions against Pallas
@pytest.mark.parametrize("D", [128, 256])
def test_flash_fwd_plain_matches_pallas_interpret_f16(D):
    q, k, v = inputs(0, (1, 256, 2, D), 3)
    jo, jlse = jfa._flash_fwd_impl(to_jax(q), to_jax(k), to_jax(v),
                                   interpret=True)
    o, lse = fa.flash_fwd(q, k, v)                # CPU: the plain version
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    assert ratio(o, to_torch(jo)) <= 1
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("g_scale", [1.0, 2.0 ** -16])
@pytest.mark.parametrize("D", [128, 256])
def test_flash_bwd_plain_matches_pallas_interpret_f16(D, g_scale):
    q, k, v, g = inputs(1, (1, 256, 2, D), 4, g_scale)
    jo, jlse = jfa._flash_fwd_impl(to_jax(q), to_jax(k), to_jax(v),
                                   interpret=True)
    want = jfa._flash_bwd_impl(to_jax(q), to_jax(k), to_jax(v), jo, jlse,
                               to_jax(g), interpret=True)
    o, lse = to_torch(jo), to_torch(jlse, torch.float32)
    delta = fa.bwd_delta(o, g)
    got = (fa.flash_dq(q, k, v, g, lse, delta),
           *fa.flash_dkv(q, k, v, g, lse, delta))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = to_torch(b)
        assert ratio(a, b) <= 1, (name, ratio(a, b))
        # the small cotangent's gradients are float16 subnormals, not zeros
        assert a.float().abs().max() > 0, name


# ------------------------------------------- the float16 kernels, emulated
def floor_log2(m):
    """floor(log2 m) of positive float32 values, exactly."""
    return torch.frexp(m)[1] - 1


def split16(x):
    """x (float32) as its float16 terms hi + mid, each widened (torch's
    float16 rounding is to nearest with subnormals, as cvt.rn)."""
    hi = x.half().float()
    return hi, (x - hi).half().float()


class KernelF16:
    """The float16 kernels' arithmetic on [B, L, H, D] float16 tensors
    (csrc/flash_attention.cu, the <__half, HD> instances): products of
    float16 values summed in float32; the forward's online softmax over key
    tiles (128 keys at D 128, 64 at 256) with p rounded to float16; dq over
    key tiles (64 at D 128, 32 at 256), dk/dv over 64-row query tiles, with
    p^T x 2^14 and ds (ds^T) x 2^e, e per accumulator row, split into two
    float16 terms, the row's accumulator rescaled when e falls, the scales
    undone at the store. ``scaled=False``: the split without the scales."""

    P_E, E0 = 14, 74

    def __init__(self, D, scaled=True):
        self.D, self.scaled = D, scaled
        self.fwd_keys, self.dq_keys, self.dkv_rows = (
            128 * 128 // D, 64 * 128 // D, 64)

    def forward(self, q, k, v):
        B, L, H, D = q.shape
        qh, kh, vh = (x.float().transpose(1, 2) for x in (q, k, v))
        s = qh @ kh.transpose(-1, -2) / math.sqrt(D)
        keep = torch.arange(L)[None, :] <= torch.arange(L)[:, None]
        s = s.masked_fill(~keep, fa.NEG_INF)
        m = torch.full((B, H, L, 1), fa.NEG_INF)
        l = torch.zeros((B, H, L, 1))
        acc = torch.zeros((B, H, L, D))
        for k0 in range(0, L, self.fwd_keys):
            st = s[..., k0:k0 + self.fwd_keys]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(st - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.half().float() @ vh[:, :, k0:k0 + self.fwd_keys]
            m = m_new
        l = l.clamp_min(1e-30)
        o = (acc / l).transpose(1, 2).half()
        return o, (m + torch.log(l)).reshape(B * H, L)

    def _row_scales(self, ds, e):
        """(ds x 2^e_new, e_new, 2^(e_new - e)) for one tile: rows along
        axis -2, the tile's columns along -1."""
        if not self.scaled:
            return ds, e, torch.ones_like(ds[..., :1])
        m = ds.abs().amax(-1, keepdim=True).clamp(2.0 ** -60, 2.0 ** 60)
        e_new = torch.minimum(e, 14 - floor_log2(m))
        return (ds * torch.exp2(e_new.float()), e_new,
                torch.exp2((e_new - e).float()))

    def _terms(self, B, L, H, q, k, v, dout, lse, delta):
        D = self.D
        qh, kh, vh, gh = (x.float().transpose(1, 2) for x in (q, k, v, dout))
        s = qh @ kh.transpose(-1, -2) / math.sqrt(D)
        keep = torch.arange(L)[None, :] <= torch.arange(L)[:, None]
        p = torch.exp(s - lse.reshape(B, H, L, 1)) * keep
        dp = gh @ vh.transpose(-1, -2)
        ds = p * (dp - delta.reshape(B, H, L, 1)) / math.sqrt(D)
        return qh, kh, gh, p, ds

    def dq(self, q, k, v, dout, lse, delta):
        B, L, H, D = q.shape
        _, kh, _, _, ds = self._terms(B, L, H, q, k, v, dout, lse, delta)
        acc = torch.zeros((B, H, L, D))
        e = torch.full((B, H, L, 1), self.E0, dtype=torch.int32)
        for k0 in range(0, L, self.dq_keys):
            scaled, e, rescale = self._row_scales(
                ds[..., k0:k0 + self.dq_keys], e)
            hi, mid = split16(scaled)
            kt = kh[:, :, k0:k0 + self.dq_keys]
            acc = acc * rescale + hi @ kt + mid @ kt
        if self.scaled:
            acc = acc * torch.exp2(-e.float())
        return acc.transpose(1, 2).half()

    def dkv(self, q, k, v, dout, lse, delta):
        B, L, H, D = q.shape
        qh, _, gh, p, ds = self._terms(B, L, H, q, k, v, dout, lse, delta)
        pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)  # [B, H, S, L]
        dk = torch.zeros((B, H, L, D))
        dv = torch.zeros((B, H, L, D))
        e = torch.full((B, H, L, 1), self.E0, dtype=torch.int32)
        p_scale = 2.0 ** self.P_E if self.scaled else 1.0
        for q0 in range(0, L, self.dkv_rows):
            cols = slice(q0, q0 + self.dkv_rows)
            hi, mid = split16(pt[..., cols] * p_scale)
            dv = dv + hi @ gh[:, :, cols] + mid @ gh[:, :, cols]
            scaled, e, rescale = self._row_scales(dst[..., cols], e)
            hi, mid = split16(scaled)
            dk = dk * rescale + hi @ qh[:, :, cols] + mid @ qh[:, :, cols]
        if self.scaled:
            dk = dk * torch.exp2(-e.float())
        dv = dv / p_scale
        return dk.transpose(1, 2).half(), dv.transpose(1, 2).half()


def emulated_vs_plain(D, g_scale, scaled=True, seed=5):
    """{output: largest error over f16_tol} of the emulated float16 kernels
    against the plain versions (lse: largest |error|), the backward from
    the plain forward's lse and delta."""
    q, k, v, g = inputs(seed, (1, 300, 2, D), 4, g_scale)
    kern = KernelF16(D, scaled)
    po, plse = fa.flash_fwd_plain(q, k, v)
    delta = fa.bwd_delta(po, g)
    o, lse = kern.forward(q, k, v)
    want = (fa.flash_dq_plain(q, k, v, g, plse, delta),
            *fa.flash_dkv_plain(q, k, v, g, plse, delta))
    got = (kern.dq(q, k, v, g, plse, delta),
           *kern.dkv(q, k, v, g, plse, delta))
    out = {"o": ratio(o, po), "lse": (lse - plse).abs().max().item()}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        out[name] = ratio(a, b)
    return out, want


@pytest.mark.parametrize("g_scale", G_SCALES)
@pytest.mark.parametrize("D", [128, 256])
def test_f16_kernel_arithmetic_within_the_card_tolerance(D, g_scale):
    errs, want = emulated_vs_plain(D, g_scale)
    assert errs["lse"] <= 1e-5, errs
    for name in ("o", "dq", "dk", "dv"):
        assert errs[name] <= 1, (name, errs)
    if g_scale < 1:
        # the plain gradients themselves are nonzero float16 values
        assert all(w.float().abs().max() > 0 for w in want)


@pytest.mark.parametrize("D", [128, 256])
def test_unscaled_f16_split_loses_small_cotangents(D):
    """Without the scales, the small cotangent's ds round to float16 zeros
    and subnormals: dq and dk miss the card tolerance by more than 10x (the
    check the scaled kernels pass above)."""
    errs, _ = emulated_vs_plain(D, 2.0 ** -16, scaled=False)
    assert min(errs["dq"], errs["dk"]) > 10, errs


def test_row_scales_bound_every_term():
    """Every scaled ds lies under 2^15 (its float16 terms under 65504) and
    the split keeps 22 bits of it, from the largest float16 products down
    to the clamp's 2^-60 of the row's max."""
    kern = KernelF16(128)
    rng = np.random.default_rng(7)
    mags = np.float32(2.0) ** rng.uniform(-100, 38, (64, 64)).astype(np.float32)
    ds = torch.from_numpy(mags * rng.choice([-1, 1], (64, 64)).astype(np.float32))
    e = torch.full((64, 1), kern.E0, dtype=torch.int32)
    scaled, e, _ = kern._row_scales(ds, e)
    assert bool((scaled.abs() < 2 ** 15).all())
    hi, mid = split16(scaled)
    assert bool(torch.isfinite(hi).all() and (hi.abs() <= 65504).all())
    row_max = ds.abs().amax(-1, keepdim=True)
    kept = ds.abs() >= 2.0 ** -60 * row_max
    err = (hi.double() + mid.double() - scaled.double()).abs()
    bound = 2.0 ** -22 * scaled.double().abs() + 2.0 ** -25
    assert bool((err <= bound)[kept].all())


# ----------------------------------------------------- LlamaLM and the SFT
@pytest.fixture(scope="module", params=[128, 256])
def narrow(request):
    """A flax LlamaLM at head dim 128 or 256 (GQA 2:1) and its params."""
    D = request.param
    tokens = np.random.default_rng(5).integers(3, 300, (2, 40)).astype(np.int32)
    jm = JLlamaLM(JLlamaConfig(**NARROW[D], dtype="float32"))
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(tokens[:, :8]))
    return D, tokens, params


def test_llama_f16_logits_match_flax(narrow):
    D, tokens, params = narrow
    cfg = LlamaConfig(**NARROW[D], dtype="float16")
    assert cfg.head_dim == D
    want, _ = JLlamaLM(JLlamaConfig(**NARROW[D], dtype="float16")).apply(
        params, jnp.asarray(tokens))
    model = LlamaLM(cfg)
    model.load_state_dict(bridge.llama_from_flax(params))
    with torch.no_grad():
        got, _ = model.eval()(torch.from_numpy(tokens).long())
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=5e-3 * np.abs(want).max())


def test_sft_f16_three_steps_match_jax(narrow, tmp_path):
    """Three float16 SFTTrainer steps from the same weights and batches
    (clip 0.5, weight decay 0.01, warmup and cosine): losses and every
    parameter after each step agree with the JAX trainer's."""
    D, _, params = narrow
    rng = np.random.default_rng(6)
    tokens = rng.integers(3, 300, (6, 33)).astype(np.int32)
    mask = (rng.random((6, 33)) < 0.6).astype(np.float32)
    kw = dict(learning_rate=1e-3, weight_decay=0.01, warmup_steps=1,
              total_steps=3, batch_size=4, grad_clip=0.5, save_every=1000)
    jtr = JSFTTrainer(JLlamaConfig(**NARROW[D], dtype="float16"),
                      JSFTConfig(output_dir=str(tmp_path / "j"), **kw),
                      params=jax.tree_util.tree_map(jnp.array, params))
    tr = SFTTrainer(LlamaConfig(**NARROW[D], dtype="float16"),
                    SFTConfig(output_dir=str(tmp_path / "t"), **kw),
                    params=bridge.llama_from_flax(params), device="cpu")
    lr = kw["learning_rate"]
    for step in (1, 2, 3):
        jloss = jtr.train(tokens, mask, steps=step, resume=False)
        loss = tr.train(tokens, mask, steps=step, resume=False)
        np.testing.assert_allclose(loss, jloss, rtol=1e-4)
        want = bridge.llama_from_flax(jtr.params)
        for name, p in tr.model.named_parameters():
            # Adam divides a gradient by its RMS, so the two frameworks'
            # gradient noise (float16 activations rounded at other points of
            # sums in other orders: ~NOISE of the tensor's largest) moves an
            # element by up to lr x that noise / its own RMS a step: held to
            # rtol 1e-4 + atol 1e-6 plus 3 lr x min(1, NOISE max(rms) / rms)
            rms = (tr.opt.state[p]["exp_avg_sq"] / (1 - 0.999 ** step)
                   ).sqrt().numpy()
            noise = 3 * lr * np.minimum(
                1.0, NOISE * rms.max() / np.maximum(rms, 1e-30))
            got, ref = p.detach().numpy(), want[name].numpy()
            excess = np.abs(got - ref) - (1e-4 * np.abs(ref) + 1e-6 + noise)
            assert excess.max() <= 0, (name, step, excess.max())
    assert tr.step == jtr.step == 3

