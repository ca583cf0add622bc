"""Head dims 1152 to 2048 in bfloat16 and float16 in the LLM reader against
the JAX package on the CPU.

The port's bfloat16 and float16 flash kernels take every head dim from 640
to 2048 (a multiple of 128) on the card, each as a cluster of NB =
ceil(D / 256) blocks, five to eight past 1024, each on a share of whole
64-column boxes, the shares differing by at most one box (3 x 256 + 2 x 192
at 1152, 4 x 256 + 2 x 192 at 1408, 8 x 256 at 2048), whose partial scores
are added in rank order, ((p0 + p1) + p2) + .. (csrc/flash_attention.cu,
``flash_*_cluster_kernel<T, 256>``); float32 stops at 1024. Their plain
versions (what a CPU tensor runs, and the card check's yardstick), an
emulation of the clusters' arithmetic, the flash rule and a LlamaLM with a
head of 2048 (chip_smoke.py's step-time-llm-d2048 phase runs LLaMA-2-7B's
4,096 query columns as 2 such heads) are held here to the JAX package on
the same numpy inputs. Tolerances are tests/test_torch_flash_d1024_16.py's
(``bf16_tol`` and ``f16_tol`` are the card check's per-element tolerances,
chip_smoke.attn_err):

* plain flash versions vs the Pallas kernels in interpret mode (B1 L256
  H1, D 1152 and 2048): o, dq, dk and dv to
  ``bf16_tol`` / ``f16_tol``, lse to 2e-4 (bfloat16) and 1e-5 (float16);
  the backward from JAX's o and lse on both sides, float16 also with the
  cotangent x 2^-16;
* the clusters emulated (``KernelCluster16`` of
  tests/test_torch_flash_d1024_16.py) vs the plain versions at B1 L160 H2
  and every head dim from 1152 to 2048: dq, dk and dv within a quarter of
  the card tolerance of their rounded values of the function in float64
  (float16's dq carries the float rounding of dp's D-term sum where dp -
  delta cancels, the first query rows: at D 1408-1920 and L160 it lies
  0.06-0.13 of the tolerance off, and the float32 plain backward 0.04-0.11;
  bf16 and every dk and dv under 0.01; with one partial missing, or
  float16's ds split unscaled, they lie hundreds of tolerances off, with
  the mid terms dropped 0.64-0.79 of it), lse within 1e-5, o
  (rounded) within the card tolerance; float16 also with the cotangent x
  2^-16 and x 2^4 at 1408 (shares of 256 and 192) and 2048 (all 256); the
  rank-order sum within D 2^-24 of the sum of its terms' sizes of the
  float64 product, and unequal on some element to the reverse order's sum;
* ``flash_applies`` and ``HEAD_DIMS``: 16-bit heads to 2048 on the card
  (and on to 4096, tests/test_torch_flash_d4096.py), float32 to 2048
  (and on to 2304, tests/test_torch_flash_d2304.py), neither at the first
  head dim the kernels refuse (16-bit 4224, past sixteen blocks of 256
  columns; float32 2432, past twelve of 192), nothing on the CPU;
* LlamaLM at head dim 2048 (dim 2048, one head and one kv head, 1 layer):
  logits bfloat16 2e-2 and float16 5e-3 of max|logit| (head dim 1024's);
* three bfloat16 SFT steps: each loss to ``LOSS_RTOL`` and every parameter
  rtol 1e-4 + atol 1e-6 plus Adam's share of the gradient noise
  (``NOISE``), each twice what this model needs here.

The emulation runs on one torch thread (a fixture, as
tests/test_torch_flash_split3.py): its many small products oversubscribe
the cores when the suite runs in parallel workers.
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
from test_torch_flash_d512 import inputs, ratio, to_jax, to_torch, tol
from test_torch_flash_d1024_16 import KernelCluster16, cluster16_shares

# head dim 2048 (one head, one kv head) at a CPU width
NARROW = dict(vocab_size=300, dim=2048, n_layers=1, n_heads=1, n_kv_heads=1,
              intermediate=384, max_seq_len=256)
WIDE_DIMS = [1152, 1280, 1408, 1536, 1664, 1792, 1920, 2048]
# the SFT test's needs, measured here at the third step (the parameters
# have drifted apart by then): the loss 9.5e-4 relative; the gradient noise
# as a share of a tensor's largest gradient RMS, 0.23 (at the second step
# 3.7e-5 and 0.0026); each twice that
LOSS_RTOL = 1.9e-3
NOISE = 0.46


@pytest.fixture
def one_thread():
    """One torch thread for an emulation test, the pool's size restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------- plain versions against Pallas
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("D", [1152, 2048])
def test_flash_fwd_plain_matches_pallas_interpret_d2048_16(D, dtype):
    q, k, v = inputs(0, (1, 256, 1, D), 3, dtype)
    jo, jlse = jfa._flash_fwd_impl(to_jax(q), to_jax(k), to_jax(v),
                                   interpret=True)
    o, lse = fa.flash_fwd(q, k, v)                # CPU: the plain version
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert ratio(o, to_torch(jo, q.dtype)) <= 1
    lse_tol = 1e-5 if dtype == "float16" else 2e-4
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=lse_tol,
                               atol=lse_tol)


@pytest.mark.parametrize("dtype,g_scale", [("bfloat16", 1.0),
                                           ("float16", 1.0),
                                           ("float16", 2.0 ** -16)])
@pytest.mark.parametrize("D", [1152, 2048])
def test_flash_bwd_plain_matches_pallas_interpret_d2048_16(D, dtype,
                                                           g_scale):
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
        assert ratio(a, b) <= 1, (name, ratio(a, b))
        # the small cotangent's gradients are float16 subnormals, not zeros
        assert a.float().abs().max() > 0, name


# --------------------------------------------- the clusters, emulated
def test_cluster_shares_reach_2048_on_eight_blocks():
    """ceil(D / 256) blocks of 192 or 256 columns at every head dim from
    640 to 2048, the shares covering the row, the wider first: five blocks
    at 1152, six at 1408, eight at 2048; the port's plan is the
    emulation's."""
    for D in range(640, 2049, 128):
        shares = cluster16_shares(D)
        assert len(shares) == -(-D // 256) <= 8, D
        assert sum(shares) == D and set(shares) <= {192, 256}, D
        assert shares == sorted(shares, reverse=True), D
        assert fa.cluster16_shares(D) == shares, D
    assert cluster16_shares(1152) == [256] * 3 + [192] * 2
    assert cluster16_shares(1408) == [256] * 4 + [192] * 2
    assert cluster16_shares(2048) == [256] * 8


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("D,dtype,g_scale", [
    *((D, dtype, 1.0) for D in WIDE_DIMS for dtype in ("bfloat16", "float16")),
    *((D, "float16", s) for D in (1408, 2048) for s in (2.0 ** -16, 2.0 ** 4))])
def test_cluster_kernel_arithmetic_within_the_card_tolerance_d2048(
        D, dtype, g_scale):
    q, k, v, g = inputs(5, (1, 160, 2, D), 4, dtype, g_scale)
    kern = KernelCluster16(D, q.dtype)
    po, plse = fa.flash_fwd_plain(q, k, v)
    delta = fa.bwd_delta(po, g)
    o, lse = kern.forward(q, k, v)
    assert ratio(o.to(q.dtype), po) <= 1
    assert (lse - plse).abs().max().item() <= 1e-5
    got = (kern.dq(q, k, v, g, plse, delta),
           *kern.dkv(q, k, v, g, plse, delta))
    # the backward's function in float64 on the same inputs, before its
    # rounding, and the plain backward rounded (the tolerance's scale, as
    # the card check holds the kernels' rounded outputs)
    wide = [x.double() for x in (q, k, v, g, plse, delta)]
    p, ds = fa._dscores(*wide)
    exact = (torch.einsum("bhls,bshd->blhd", ds, wide[1]),
             torch.einsum("bhls,blhd->bshd", ds, wide[0]),
             torch.einsum("bhls,blhd->bshd", p, wide[3]))
    rounded = (fa.flash_dq_plain(q, k, v, g, plse, delta),
               *fa.flash_dkv_plain(q, k, v, g, plse, delta))
    for name, a, x, r in zip(("dq", "dk", "dv"), got, exact, rounded):
        err = ((a.double() - x).abs() / tol(r)).max().item()
        assert err <= 0.25, (name, err)
        if g_scale < 1:      # the plain gradients are nonzero float16 values
            assert r.float().abs().max() > 0, name


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_cluster_scores_sum_in_rank_order_d2048(D):
    """The rank-order sum of the NB blocks' partial scores is the float
    product of the 16-bit inputs to within the float rounding of a D-term
    sum (D 2^-24 of the sum of its terms' sizes, against the float64
    product), and the reverse order's sum of the same partials differs
    from it on some element: every block must add them alike."""
    q, k = inputs(9, (1, 160, 2, D), 2, "bfloat16")
    qh, kh = (x.float().transpose(1, 2) for x in (q, k))
    kern = KernelCluster16(D, q.dtype)
    s = kern.scores(qh, kh)
    exact = qh.double() @ kh.double().transpose(-1, -2)
    size = qh.double().abs() @ kh.double().abs().transpose(-1, -2)
    assert bool(((s.double() - exact).abs() <= D * 2.0 ** -24 * size).all())
    reverse = kern.scores(qh, kh, order=range(kern.NB - 1, -1, -1))
    assert not torch.equal(s, reverse)


# --------------------------------------------------------------- the rule
@pytest.mark.parametrize("head_dim,dtype,device,want", [
    (2048, torch.bfloat16, "cuda", True),     # clusters of eight blocks
    (2048, torch.float16, "cuda", True),
    (1152, torch.bfloat16, "cuda", True),     # of five
    (1408, torch.float16, "cuda", True),      # of six
    (2048, torch.float32, "cuda", True),      # float32 to 2048 since its
    (1152, torch.float32, "cuda", True),      # clusters of nine to sixteen
    (4224, torch.bfloat16, "cuda", False),    # past a cluster of sixteen
    (4224, torch.float16, "cuda", False),
    (2432, torch.float32, "cuda", False),
    (2048, torch.bfloat16, "cpu", False)])
def test_flash_rule_takes_16bit_to_head_dim_2048(head_dim, dtype, device,
                                                 want):
    assert flash_applies(True, head_dim, dtype, device, False, False) is want
    assert not flash_applies(True, head_dim, dtype, device, True, False)
    assert not flash_applies(False, head_dim, dtype, device, False, False)
    assert (head_dim in fa.HEAD_DIMS[dtype]) is (want or (
        device == "cpu" and head_dim <= 2048))


# ----------------------------------------------------- LlamaLM and the SFT
@pytest.fixture(scope="module")
def narrow():
    """A flax LlamaLM at head dim 2048 with one kv head, and its params."""
    tokens = np.random.default_rng(5).integers(3, 300, (2, 40)).astype(np.int32)
    jm = JLlamaLM(JLlamaConfig(**NARROW, dtype="float32"))
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(tokens[:, :8]))
    return tokens, params


@pytest.mark.parametrize("dtype,tol_", [("bfloat16", 2e-2), ("float16", 5e-3)])
def test_llama_d2048_16bit_logits_match_flax(narrow, dtype, tol_):
    tokens, params = narrow
    cfg = LlamaConfig(**NARROW, dtype=dtype)
    assert cfg.head_dim == 2048 and cfg.n_kv_heads == 1
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


def test_sft_d2048_bf16_three_steps_match_jax(narrow, tmp_path):
    """Three bfloat16 SFTTrainer steps of the head-dim-2048 model from the
    same weights and batches (clip 0.5, weight decay 0.01, warmup and
    cosine): losses and every parameter after each step agree with the JAX
    trainer's (as tests/test_torch_flash_d1024_16.py holds head dim 1024)."""
    _, params = narrow
    rng = np.random.default_rng(6)
    tokens = rng.integers(3, 300, (6, 33)).astype(np.int32)
    mask = (rng.random((6, 33)) < 0.6).astype(np.float32)
    kw = dict(learning_rate=1e-3, weight_decay=0.01, warmup_steps=1,
              total_steps=3, batch_size=4, grad_clip=0.5, save_every=1000)
    jtr = JSFTTrainer(JLlamaConfig(**NARROW, dtype="bfloat16"),
                      JSFTConfig(output_dir=str(tmp_path / "j"), **kw),
                      params=jax.tree_util.tree_map(jnp.array, params))
    tr = SFTTrainer(LlamaConfig(**NARROW, dtype="bfloat16"),
                    SFTConfig(output_dir=str(tmp_path / "t"), **kw),
                    params=bridge.llama_from_flax(params), device="cpu")
    lr = kw["learning_rate"]
    for step in (1, 2, 3):
        jloss = jtr.train(tokens, mask, steps=step, resume=False)
        loss = tr.train(tokens, mask, steps=step, resume=False)
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
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
