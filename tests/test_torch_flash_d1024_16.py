"""Head dims 640 to 1024 in bfloat16 and float16 in the LLM reader against
the JAX package on the CPU.

The port's bfloat16 and float16 flash kernels take head dims 640, 768, 896
and 1024 on the card, each as a cluster of NB = ceil(D / 256) blocks, each
on a share of whole 64-column boxes, the shares differing by at most one
box (256 + 192 + 192 at 640, 3 x 256 at 768, 2 x 256 + 2 x 192 at 896, 4 x
256 at 1024), whose partial scores are added in rank order, ((p0 + p1) +
p2) + .. (csrc/flash_attention.cu, the ``flash_*_cluster_kernel<T, 256>``
instances, which take every head dim from 640 to 2048;
tests/test_torch_flash_d2048_16.py holds 1152 to 2048). Their plain
versions (what a CPU tensor runs, and the card check's yardstick), an
emulation of the clusters' arithmetic and a LlamaLM
with heads of 1024 and one kv head (LLaMA-2-7B's query columns regrouped,
as chip_smoke.py's step-time-llm-d1024 phases run it) are held here to the
JAX package on the same numpy inputs. Tolerances (``bf16_tol`` and
``f16_tol`` are the card check's per-element tolerances,
chip_smoke.attn_err):

* plain flash versions vs the Pallas kernels in interpret mode (B1 L256 H2,
  D 640 and 1024): o, dq, dk and dv to ``bf16_tol`` / ``f16_tol``, lse to
  2e-4 (bfloat16) and 1e-5 (float16), as tests/test_torch_flash_d512.py
  holds 384 and 512; the backward from JAX's o and lse on both sides,
  float16 also with the cotangent x 2^-16;
* the clusters emulated (``KernelCluster16``: tests/test_torch_flash_d512.py's
  ``KernelPair`` with s and dp as NB float partials, each over one block's
  share of the columns, added in rank order) vs the plain versions at B1
  L300 H2 and every head dim from 640 to 1024: dq, dk and dv in float
  within 0.1 of the card tolerance of their rounded values, lse within
  1e-5, o (rounded) within the card tolerance; float16 also with the
  cotangent x 2^-16 and x 2^4 at 640 and 1024 (three and four blocks); the
  rank-order sum within D 2^-24 of the sum of its terms' sizes of the
  float64 product, and unequal on some element to
  the sum of the same partials in the reverse order (three or more float
  partials do not add the same in every order: the kernels must all add
  them alike);
* LlamaLM at head dim 1024 (dim 2048, 2 heads, 1 kv head, 2 layers):
  logits bfloat16 2e-2 and float16 5e-3 of max|logit| (head dim 512's);
* three bfloat16 and three float16 SFT steps: each loss to ``LOSS_RTOL``
  and every parameter rtol 1e-4 + atol 1e-6 plus Adam's share of the
  gradient noise (``NOISE``), each twice what this model needs here.

The emulation runs on one torch thread (a module fixture, as
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
from gnn_rag_tpu_torch.llm.model import LlamaConfig, LlamaLM
from gnn_rag_tpu_torch.llm.sft import SFTConfig, SFTTrainer
from test_torch_flash_d512 import (KernelPair, inputs, ratio, to_jax, to_torch,
                                   tol)

# head dim 1024 and one kv head at a CPU width
NARROW = dict(vocab_size=300, dim=2048, n_layers=2, n_heads=2, n_kv_heads=1,
              intermediate=384, max_seq_len=256)
WIDE_DIMS = [640, 768, 896, 1024]
# the SFT test's needs, measured here at the third step (the parameters
# have drifted apart by then): the loss 6.5e-4 (bfloat16) and 1.2e-4
# (float16) relative; the gradient noise as a share of a tensor's largest
# gradient RMS, 0.28 and 0.17 (at the second step 0.0046 and 6.5e-4); each
# twice that
LOSS_RTOL = {"bfloat16": 1.3e-3, "float16": 2.4e-4}
NOISE = {"bfloat16": 0.56, "float16": 0.34}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for the module, the pool's size restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------- plain versions against Pallas
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("D", [640, 1024])
def test_flash_fwd_plain_matches_pallas_interpret_d1024_16(D, dtype):
    q, k, v = inputs(0, (1, 256, 2, D), 3, dtype)
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
@pytest.mark.parametrize("D", [640, 1024])
def test_flash_bwd_plain_matches_pallas_interpret_d1024_16(D, dtype,
                                                           g_scale):
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
        assert ratio(a, b) <= 1, (name, ratio(a, b))
        # the small cotangent's gradients are float16 subnormals, not zeros
        assert a.float().abs().max() > 0, name


# --------------------------------------------- the clusters, emulated
def cluster16_shares(D):
    """The columns of each block of a 16-bit cluster at head dim D, rank by
    rank (the kernels' ``cluster16_blocks`` and ``share16_units``): one
    block for every 256 columns, rounded up, the D / 64 boxes dealt so that
    the shares differ by at most one box, the wider first."""
    nb = (D + 255) // 256
    base, extra = divmod(D // 64, nb)
    return [64 * (base + (r < extra)) for r in range(nb)]


class KernelCluster16(KernelPair):
    """The 16-bit cluster kernels' arithmetic: ``KernelPair``'s tiles and
    splits, with every score s = q k^T and dp = dO v^T the sum of NB float
    partials, each over one block's share of the columns
    (``cluster16_shares``), added in rank order ((p0 + p1) + p2) + .. +
    p(NB - 1), the order every block of the cluster adds them in."""

    def __init__(self, D, dtype):
        super().__init__(D, dtype)
        self.shares = cluster16_shares(D)
        self.NB = len(self.shares)

    def partials(self, a, b):
        cols = np.cumsum([0, *self.shares])
        return [a[..., c0:c1] @ b[..., c0:c1].transpose(-1, -2)
                for c0, c1 in zip(cols[:-1], cols[1:])]

    def scores(self, a, b, order=None):
        parts = self.partials(a, b)
        total = None
        for r in (range(self.NB) if order is None else order):
            total = parts[r] if total is None else total + parts[r]
        return total


def test_cluster_blocks_are_the_kernels():
    """The emulation's plan is the port's (``cluster16_shares``): two
    blocks at 384 and 512, three at 640 and 768, four at 896 and 1024, none
    wider than 256 columns, the shares of whole boxes covering the row."""
    want = {384: [192, 192], 512: [256, 256], 640: [256, 192, 192],
            768: [256] * 3, 896: [256, 256, 192, 192], 1024: [256] * 4}
    assert {D: cluster16_shares(D) for D in want} == want
    assert {D: fa.cluster16_shares(D) for D in want} == want


@pytest.mark.parametrize("D,dtype,g_scale", [
    *((D, dtype, 1.0) for D in WIDE_DIMS for dtype in ("bfloat16", "float16")),
    *((D, "float16", s) for D in (640, 1024) for s in (2.0 ** -16, 2.0 ** 4))])
def test_cluster_kernel_arithmetic_within_the_card_tolerance(D, dtype,
                                                             g_scale):
    q, k, v, g = inputs(5, (1, 300, 2, D), 4, dtype, g_scale)
    kern = KernelCluster16(D, q.dtype)
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


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_cluster_scores_sum_in_rank_order(D):
    """The rank-order sum of the NB blocks' partial scores is the float
    product of the 16-bit inputs to within the float rounding of a D-term
    sum (D 2^-24 of the sum of its terms' sizes, against the float64
    product), and another order's sum of the same partials differs from it
    on some element: every block must add them in the same order."""
    q, k = inputs(9, (1, 200, 2, D), 2, "bfloat16")
    qh, kh = (x.float().transpose(1, 2) for x in (q, k))
    kern = KernelCluster16(D, q.dtype)
    s = kern.scores(qh, kh)
    exact = qh.double() @ kh.double().transpose(-1, -2)
    size = qh.double().abs() @ kh.double().abs().transpose(-1, -2)
    assert bool(((s.double() - exact).abs() <= D * 2.0 ** -24 * size).all())
    reverse = kern.scores(qh, kh, order=range(kern.NB - 1, -1, -1))
    assert not torch.equal(s, reverse)


# ----------------------------------------------------- LlamaLM and the SFT
@pytest.fixture(scope="module")
def narrow():
    """A flax LlamaLM at head dim 1024 with one kv head, and its params."""
    tokens = np.random.default_rng(5).integers(3, 300, (2, 40)).astype(np.int32)
    jm = JLlamaLM(JLlamaConfig(**NARROW, dtype="float32"))
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(tokens[:, :8]))
    return tokens, params


@pytest.mark.parametrize("dtype,tol_", [("bfloat16", 2e-2), ("float16", 5e-3)])
def test_llama_d1024_16bit_logits_match_flax(narrow, dtype, tol_):
    tokens, params = narrow
    cfg = LlamaConfig(**NARROW, dtype=dtype)
    assert cfg.head_dim == 1024 and cfg.n_kv_heads == 1
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_sft_d1024_16bit_three_steps_match_jax(narrow, dtype, tmp_path):
    """Three SFTTrainer steps of the head-dim-1024 model in a 16-bit type
    from the same weights and batches (clip 0.5, weight decay 0.01, warmup
    and cosine): losses and every parameter after each step agree with the
    JAX trainer's (as tests/test_torch_flash_d512.py holds head dim 512)."""
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
            # Adam divides a gradient by its RMS: the frameworks' gradient
            # noise moves an element by up to lr x that noise / its own RMS
            # a step (tests/test_torch_flash_d512.py)
            rms = (tr.opt.state[p]["exp_avg_sq"] / (1 - 0.999 ** step)
                   ).sqrt().numpy()
            noise = 3 * lr * np.minimum(
                1.0, NOISE[dtype] * rms.max() / np.maximum(rms, 1e-30))
            got, ref = p.detach().numpy(), want[name].numpy()
            excess = np.abs(got - ref) - (1e-4 * np.abs(ref) + 1e-6 + noise)
            assert excess.max() <= 0, (name, step, excess.max())
    assert tr.step == jtr.step == 3
