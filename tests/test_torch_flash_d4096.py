"""Float32 at head dims 1152 to 2048 and bfloat16 and float16 at 2176 to
4096 in the LLM reader against the JAX package on the CPU.

The port's flash kernels take every head dim a multiple of 128 on the card
up to Hopper's largest thread block cluster, sixteen blocks (past eight its
non-portable sizes): float32 to 2048, as clusters of D / 128 blocks, nine
to sixteen past 1024, each on 128 columns (csrc/flash_attention.cu,
``flash_*_split3_kernel<SPLIT3_ANY>``, whose cluster size is a launch
attribute); bfloat16 and float16 to 4096, as clusters of ceil(D / 256)
blocks, nine to sixteen past 2048, each on a share of whole 64-column boxes
(7 x 256 + 2 x 192 at 2176, 14 x 256 + 2 x 192 at 3968, 16 x 256 at 4096,
``flash_*_cluster_kernel<T, 256>``); the blocks' partial scores are added
in rank order, ((p0 + p1) + p2) + .. + p15. Their plain versions (what a
CPU tensor runs, and the card check's yardstick), emulations of the
clusters' arithmetic and LlamaLMs with one head of 2048 (float32) and of
4096 (bfloat16; chip_smoke.py's step-time-llm-d2048-fp32 and
step-time-llm-d4096 phases run LLaMA-2-7B's 4,096 query columns as 2 and 1
such heads) are held here to the JAX package on the same numpy inputs:

* plain flash versions vs the Pallas kernels in interpret mode (B1 L256
  H1): float32 at D 1152 and 2048, o and lse to 2e-4, dq, dk and dv to
  5e-4, relative and absolute (tests/test_torch_flash_d1024.py's: the two
  sum in other orders); bfloat16 and float16 at D 2176 and 4096, o, dq, dk
  and dv to ``bf16_tol`` / ``f16_tol`` (the card check's per-element
  tolerances, chip_smoke.attn_err), lse to 2e-4 / 1e-5, the float16
  backward also with the cotangent x 2^-16
  (tests/test_torch_flash_d2048_16.py's);
* the float32 clusters emulated at 1152 and 2048 (tests/
  test_torch_flash_split3.py's helpers: each float as three bf16 terms,
  six products a product, the D / 128 partial scores added in rank order,
  the kernels' tiles) and the 16-bit ones at 2176, 3968 and 4096
  (``KernelCluster16`` of tests/test_torch_flash_d1024_16.py), at B1 L160:
  each output within a quarter of the card tolerance of the function in
  float64 (float32: 1e-4 of max|plain|; 16 bits: dq, dk and dv to
  ``bf16_tol`` / ``f16_tol`` of the plain outputs, o to the plain o and
  lse to 1e-5, as tests/test_torch_flash_d2048_16.py);
* the sixteen-partial rank-order sum (float32 at 2048, 16 bits at 4096)
  within D 2^-24 of the sum of its terms' sizes of the float64 product
  (float32's six products: within 2^-21 of it plus the partials' and the
  adds' roundings, tests/test_torch_flash_split3.py's bound), and unequal
  on some element to the reverse order's sum;
* ``cluster16_shares`` from 2176 to 4096: nine to sixteen blocks of 192 or
  256 columns;
* a float32 LlamaLM at head dim 2048 (dim 2048, one head, one kv head, 1
  layer): logits 1e-4 of max|logit|, three float32 SFT steps against the
  JAX trainer; a bfloat16 LlamaLM at head dim 4096 (dim 4096, one head, 1
  layer): logits 2e-2 of max|logit| (head dim 2048's).

The emulations run on one torch thread (a fixture, as
tests/test_torch_flash_split3.py): their many small products oversubscribe
the cores when the suite runs in parallel workers.
"""

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
from gnn_rag_tpu_torch.llm.model import LlamaConfig, LlamaLM
from gnn_rag_tpu_torch.llm.sft import SFTConfig, SFTTrainer
from test_torch_flash_d512 import inputs, ratio, to_jax, to_torch, tol
from test_torch_flash_d1024_16 import KernelCluster16, cluster16_shares

# one head of 2048 in float32 and one of 4096 in bfloat16, each with one kv
# head, at a CPU width
NARROW32 = dict(vocab_size=300, dim=2048, n_layers=1, n_heads=1,
                n_kv_heads=1, intermediate=384, max_seq_len=256,
                dtype="float32")
WIDE16 = dict(vocab_size=300, dim=4096, n_layers=1, n_heads=1, n_kv_heads=1,
              intermediate=384, max_seq_len=256)
EMULATED = (1, 160, 1)          # B, L, H of the emulations; then D
# the float32 SFT test's Adam noise share (the form of
# tests/test_torch_flash_d1024.py's NOISE): the share of a tensor's largest
# gradient RMS that the parameters after the third step need, measured
# here, 2.97e-3 (the two frameworks' clipped gradients themselves differ by
# 2.7e-4 of it at the third step, 7.2e-5 at the second); twice that
NOISE = 5.9e-3


@pytest.fixture
def one_thread():
    """One torch thread for an emulation test, the pool's size restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(got, want, tol_):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    err = ((got - want).abs() / (tol_ * (1 + want.abs()))).max().item()
    assert err <= 1, err


# ------------------------------------------- plain versions against Pallas
@pytest.mark.parametrize("D,dtype", [(1152, "float32"), (2048, "float32"),
                                     (2176, "bfloat16"), (4096, "bfloat16"),
                                     (2176, "float16"), (4096, "float16")])
def test_flash_fwd_plain_matches_pallas_interpret_d4096(D, dtype):
    q, k, v = inputs(0, (1, 256, 1, D), 3, dtype)
    jo, jlse = jfa._flash_fwd_impl(to_jax(q), to_jax(k), to_jax(v),
                                   interpret=True)
    o, lse = fa.flash_fwd(q, k, v)                # CPU: the plain version
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    if dtype == "float32":
        assert_close(o, to_torch(jo, q.dtype), 2e-4)
        assert_close(lse, to_torch(jlse, torch.float32), 2e-4)
        return
    assert ratio(o, to_torch(jo, q.dtype)) <= 1
    lse_tol = 1e-5 if dtype == "float16" else 2e-4
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=lse_tol,
                               atol=lse_tol)


@pytest.mark.parametrize("D,dtype,g_scale", [
    (1152, "float32", 1.0), (2048, "float32", 1.0),
    *((D, dtype, 1.0) for D in (2176, 4096) for dtype in ("bfloat16",
                                                          "float16")),
    (2176, "float16", 2.0 ** -16), (4096, "float16", 2.0 ** -16)])
def test_flash_bwd_plain_matches_pallas_interpret_d4096(D, dtype, g_scale):
    q, k, v, g = inputs(1, (1, 256, 1, D), 4, dtype, g_scale)
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
        if dtype == "float32":
            assert_close(a, b, 5e-4)
            continue
        assert ratio(a, b) <= 1, (name, ratio(a, b))
        # the small cotangent's gradients are float16 subnormals, not zeros
        assert a.float().abs().max() > 0, name


# --------------------------------------------- the clusters, emulated
def test_cluster_shares_reach_4096_on_sixteen_blocks():
    """ceil(D / 256) blocks of 192 or 256 columns at every head dim from
    2176 to 4096, the shares covering the row, the wider first: nine
    blocks at 2176, sixteen from 3968; the port's plan is the
    emulation's."""
    for D in range(2176, 4097, 128):
        shares = cluster16_shares(D)
        assert 9 <= len(shares) == -(-D // 256) <= 16, D
        assert sum(shares) == D and set(shares) <= {192, 256}, D
        assert shares == sorted(shares, reverse=True), D
        assert fa.cluster16_shares(D) == shares, D
    assert cluster16_shares(2176) == [256] * 7 + [192] * 2
    assert cluster16_shares(3968) == [256] * 14 + [192] * 2
    assert cluster16_shares(4096) == [256] * 16


def exact_backward(q, k, v, g, lse, delta):
    """(dq, dk, dv) of the function in float64 on these inputs, unrounded."""
    wide = [x.double() for x in (q, k, v, g, lse, delta)]
    p, ds = fa._dscores(*wide)
    return (torch.einsum("bhls,bshd->blhd", ds, wide[1]),
            torch.einsum("bhls,blhd->bshd", ds, wide[0]),
            torch.einsum("bhls,blhd->bshd", p, wide[3]))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("D", [1152, 2048])
def test_split3_cluster_arithmetic_within_a_quarter_of_the_tolerance(D):
    """The float32 clusters of nine and sixteen blocks, emulated: o and lse
    (forward), dq and dk, dv (the backward from the plain forward's lse and
    delta) within 0.25 x 1e-4 of max|plain| (the card check's tolerance)
    of the function in float64."""
    q, k, v, g = inputs(5, (*EMULATED, D), 4, "float32")
    po, plse = fa.flash_fwd_plain(q, k, v)
    delta = fa.bwd_delta(po, g)
    o, lse, _ = split3.forward_split3(q, k, v)
    dq, _ = split3.dq_split3(q, k, v, g, plse, delta)
    dk, dv, _ = split3.dkv_split3(q, k, v, g, plse, delta)
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
@pytest.mark.parametrize("D,dtype,g_scale", [
    (2176, "bfloat16", 1.0), (3968, "float16", 1.0), (4096, "bfloat16", 1.0),
    (4096, "float16", 1.0), (4096, "float16", 2.0 ** -16)])
def test_cluster16_arithmetic_within_a_quarter_of_the_tolerance(D, dtype,
                                                                 g_scale):
    """The 16-bit clusters of nine and sixteen blocks, emulated: o within
    the card tolerance of the plain o and lse within 1e-5 (p rounds to the
    16-bit type before PV at another point of the softmax), dq, dk and dv
    within 0.25 of the card tolerance of the function in float64."""
    q, k, v, g = inputs(5, (*EMULATED, D), 4, dtype, g_scale)
    kern = KernelCluster16(D, q.dtype)
    assert kern.NB == -(-D // 256) >= 9
    po, plse = fa.flash_fwd_plain(q, k, v)
    delta = fa.bwd_delta(po, g)
    o, lse = kern.forward(q, k, v)
    assert ratio(o.to(q.dtype), po) <= 1
    assert (lse - plse).abs().max().item() <= 1e-5
    got = (kern.dq(q, k, v, g, plse, delta),
           *kern.dkv(q, k, v, g, plse, delta))
    rounded = (fa.flash_dq_plain(q, k, v, g, plse, delta),
               *fa.flash_dkv_plain(q, k, v, g, plse, delta))
    for name, a, x, r in zip(("dq", "dk", "dv"), got,
                             exact_backward(q, k, v, g, plse, delta), rounded):
        err = ((a.double() - x).abs() / tol(r)).max().item()
        assert err <= 0.25, (name, err)
        if g_scale < 1:      # the plain gradients are nonzero float16 values
            assert r.float().abs().max() > 0, name


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("D,dtype", [(2048, "float32"), (4096, "bfloat16")])
def test_sixteen_partials_sum_in_rank_order(D, dtype):
    """A score q k^T of a cluster of sixteen blocks, the rank-order float
    sum ((p0 + p1) + ..) + p15 of the blocks' float partials, is the
    float64 product to within D 2^-24 of the sum of its terms' sizes (16
    bits, whose products are exact in float; float32 within its six
    products' 2^-21 plus one rounding of each partial and each add,
    tests/test_torch_flash_split3.py's bound, far under that), and the
    reverse order's sum of the same partials differs from it on some
    element: every block must add them alike."""
    q, k = inputs(9, (*EMULATED, D), 2, dtype)
    eq = "blhd,bshd->bhls"
    exact = torch.einsum(eq, q.double(), k.double())
    size = torch.einsum(eq, q.double().abs(), k.double().abs())
    if dtype == "float32":
        parts = split3.partials(eq, q, k)
    else:
        qh, kh = (x.float().transpose(1, 2) for x in (q, k))
        parts = KernelCluster16(D, q.dtype).partials(qh, kh)
    assert len(parts) == 16
    s = parts[0]
    for part in parts[1:]:
        s = s + part
    err = (s.double() - exact).abs()
    assert bool((err <= D * 2.0 ** -24 * size).all())
    if dtype == "float32":
        assert torch.equal(s, split3.scores(eq, q, k, []))
        rounding = 2.0 ** -24 * (2 * len(parts) - 1) * sum(
            p.double().abs() for p in parts)
        assert bool((err <= 2.0 ** -21 * size + rounding).all())
    else:
        assert torch.equal(s, KernelCluster16(D, q.dtype).scores(qh, kh))
    reverse = parts[-1]
    for part in parts[-2::-1]:
        reverse = reverse + part
    assert not torch.equal(s, reverse)


# ----------------------------------------------------- LlamaLM and the SFT
@pytest.fixture(scope="module")
def narrow32():
    """A flax float32 LlamaLM at head dim 2048 with one kv head, and its
    params."""
    tokens = np.random.default_rng(5).integers(3, 300, (2, 40)).astype(np.int32)
    jm = JLlamaLM(JLlamaConfig(**NARROW32))
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(tokens[:, :8]))
    return tokens, params


def test_llama_d2048_fp32_logits_match_flax(narrow32):
    tokens, params = narrow32
    cfg = LlamaConfig(**NARROW32)
    assert cfg.head_dim == 2048 and cfg.n_kv_heads == 1
    want, _ = JLlamaLM(JLlamaConfig(**NARROW32)).apply(params,
                                                       jnp.asarray(tokens))
    model = LlamaLM(cfg)
    model.load_state_dict(bridge.llama_from_flax(params))
    with torch.no_grad():
        got, _ = model.eval()(torch.from_numpy(tokens).long())
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_sft_d2048_fp32_three_steps_match_jax(narrow32, tmp_path):
    """Three float32 SFTTrainer steps of the head-dim-2048 model from the
    same weights and batches (clip 0.5, weight decay 0.01, warmup and
    cosine): losses (rtol 1e-5) and every parameter after each step agree
    with the JAX trainer's (as tests/test_torch_flash_d1024.py holds head
    dim 1024)."""
    _, params = narrow32
    rng = np.random.default_rng(6)
    tokens = rng.integers(3, 300, (6, 33)).astype(np.int32)
    mask = (rng.random((6, 33)) < 0.6).astype(np.float32)
    kw = dict(learning_rate=1e-3, weight_decay=0.01, warmup_steps=1,
              total_steps=3, batch_size=4, grad_clip=0.5, save_every=1000)
    jtr = JSFTTrainer(JLlamaConfig(**NARROW32),
                      JSFTConfig(output_dir=str(tmp_path / "j"), **kw),
                      params=jax.tree_util.tree_map(jnp.array, params))
    tr = SFTTrainer(LlamaConfig(**NARROW32),
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


def test_llama_d4096_bf16_logits_match_flax():
    tokens = np.random.default_rng(7).integers(3, 300, (2, 40)).astype(np.int32)
    jcfg = JLlamaConfig(**WIDE16, dtype="bfloat16")
    params = JLlamaLM(jcfg).init(jax.random.PRNGKey(8),
                                 jnp.asarray(tokens[:, :8]))
    cfg = LlamaConfig(**WIDE16, dtype="bfloat16")
    assert cfg.head_dim == 4096 and cfg.n_kv_heads == 1
    want, _ = JLlamaLM(jcfg).apply(params, jnp.asarray(tokens))
    model = LlamaLM(cfg)
    model.load_state_dict(bridge.llama_from_flax(params))
    with torch.no_grad():
        got, _ = model.eval()(torch.from_numpy(tokens).long())
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
