"""The fused-projection gate-scatter and scatter_mm of gnn_rag_tpu_torch
against the JAX package's Pallas kernels in interpret mode.

``fused_gate_scatter_fwd`` / ``_bwd`` and ``scatter_mm_fwd`` take their plain
PyTorch versions on CPU tensors; here they are held, on the same numpy
inputs, against ``_fused_kernel`` (K6a, through ``_fused_fwd_impl``),
``_fused_kernel_v2`` (K6b, ``_fused_fwd_impl_v2``), ``_fused_bwd_kernel``
(K6c, ``_fused_bwd_pallas_impl``) and ``_scatter_kernel`` (K6d,
``_scatter_mm_fwd_impl``), and the autograd ops against torch autograd
through the plain formulas. Tolerance: max|got - ref| <= 1e-5 * max|ref| +
1e-6 in float32 (sums in another order: index_add and einsums against
one-hot matmuls); 2e-2 * max|ref| for bfloat16 inputs (one rounding of rl or
of a product may fall the other way). The CUDA kernels themselves are
compared with the plain versions on the card in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gate_scatter import assert_close, make_case, torch_layout

from gnn_rag_tpu.ops import pallas_mp as pm
from gnn_rag_tpu_torch.ops import gate_scatter as gs

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def proj_case(J, *, D=16, seed=0, **kw):
    """A layout, fwd-direction gate inputs and rel_linear's w, b."""
    kl, x, E = make_case(J, D=D, seed=seed, **kw)
    rng = np.random.default_rng(seed + 11)
    x = dict(fact_rel=x["vals_f"], ins=x["ins"], prior=x["prior_f"],
             w=(rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32),
             bias=(0.1 * rng.standard_normal(D)).astype(np.float32))
    return kl, x, E


def port_inputs(kl, x, dtype=torch.float32):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    d = torch_layout(kl).fwd
    return (t["fact_rel"].to(dtype), t["w"].to(dtype), t["bias"].to(dtype),
            t["ins"].to(dtype), t["prior"], d.scatter, d.chunk_starts)


def jax_inputs(x, dtype=jnp.float32):
    return (jnp.asarray(x["fact_rel"], dtype), jnp.asarray(x["w"], dtype),
            jnp.asarray(x["bias"], dtype), jnp.asarray(x["ins"], dtype),
            jnp.asarray(x["prior"]))


def as_bjed(out, J):
    """[B, E, J*D] -> [B, J, E, D] float32 numpy, the JAX op's layout."""
    B, E, JD = out.shape
    return out.reshape(B, E, J, JD // J).permute(0, 2, 1, 3).float().numpy()


# (J, apply_relu, pad_rows, skew); skew: a layout whose first tile holds
# most chunks (E 512, 4 tiles)
FUSED_CASES = [(1, True, 0, False), (2, True, 1, False), (2, False, 0, False),
               (3, True, 0, False), (2, True, 0, True)]


def skewed_case(J, pad_rows, skew):
    size = dict(E=512, F=1500, skew=True) if skew else {}
    kl, x, E = proj_case(J, B=2 if not pad_rows else 1, pad_rows=pad_rows,
                         **size)
    if skew:
        counts = np.diff(kl.fwd.chunk_starts[0])
        assert counts[0] >= 4 and counts[0] > counts[1:].sum()
    return kl, x, E


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("J,apply_relu,pad_rows,skew", FUSED_CASES)
def test_fused_fwd_matches_k6a_and_k6b(J, apply_relu, pad_rows, skew, dtype):
    tdt, jdt = DTYPES[dtype]
    kl, x, E = skewed_case(J, pad_rows, skew)
    before = gs.fused_launches
    got = gs.fused_gate_scatter_fwd(*port_inputs(kl, x, tdt), apply_relu)
    assert gs.fused_launches == before     # CPU tensors run the plain version
    assert got.dtype == torch.float32 and got.shape[1:] == (E, J * 16)
    args = (*jax_inputs(x, jdt), jnp.asarray(kl.fwd.scatter))
    k6a = pm._fused_fwd_impl(*args, jnp.asarray(kl.fwd.chunk_tiles), E,
                             apply_relu, interpret=True)
    k6b = pm._fused_fwd_impl_v2(*args, jnp.asarray(kl.fwd.chunk_starts), E,
                                apply_relu, interpret=True)
    rel, abs_ = (1e-5, 1e-6) if dtype == "float32" else (2e-2, 0.0)
    for want in (k6a, k6b):
        assert_close(as_bjed(got, J), np.asarray(want, np.float32), rel, abs_)
    if pad_rows:
        assert not got[-pad_rows:].any()


def test_fused_fwd_rounds_rl_once_with_the_bias_in_float():
    """bf16: rl = bf16(float(fr @ w) + float(b)), as K6a/b (one rounding);
    the v4 path's ``fact_rel @ w + b`` in bf16 rounds twice and differs."""
    kl, x, E = proj_case(2, D=16)
    fr, w, b, ins, prior, sc, cs = port_inputs(kl, x, torch.bfloat16)
    got = gs.fused_gate_scatter_fwd(fr, w, b, ins, prior, sc, cs)
    rl = (fr.float() @ w.float() + b.float()).to(torch.bfloat16)
    want = gs.gate_scatter_fwd((rl,), ins, (prior,), (sc,), (cs,))[0]
    assert torch.equal(got, want)
    twice = gs.gate_scatter_fwd((fr @ w + b,), ins, (prior,), (sc,), (cs,))[0]
    assert not torch.equal(got, twice)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("J,apply_relu,pad_rows,skew", FUSED_CASES)
def test_fused_bwd_matches_k6c(J, apply_relu, pad_rows, skew, dtype):
    """All five outputs against the TPU backward kernel, which recomputes rl
    in float32 unrounded and reads the prior unrounded; pad slots and the
    batch-padding row get zero gradients."""
    tdt, jdt = DTYPES[dtype]
    kl, x, E = skewed_case(J, pad_rows, skew)
    B = kl.fwd.scatter.shape[0]
    g = np.random.default_rng(5).standard_normal((B, J, E, 16)).astype(np.float32)
    g_port = torch.from_numpy(g).permute(0, 2, 1, 3).reshape(B, E, J * 16)
    before = gs.fused_bwd_launches
    got = gs.fused_gate_scatter_bwd(*port_inputs(kl, x, tdt),
                                    g_port.contiguous(), apply_relu)
    assert gs.fused_bwd_launches == before
    want = pm._fused_bwd_pallas_impl(
        *jax_inputs(x, jdt), jnp.asarray(kl.fwd.scatter),
        jnp.asarray(kl.fwd.chunk_tiles), jnp.asarray(g), apply_relu,
        interpret=True)
    rel, abs_ = (1e-5, 1e-6) if dtype == "float32" else (2e-2, 0.0)
    for name, a, b in zip(("dfact_rel", "dw", "dbias", "dins", "dprior"),
                          got, want):
        assert str(a.dtype) == f"torch.{b.dtype}", name
        assert_close(a.float().numpy(), np.asarray(b, np.float32), rel, abs_)
    dfr, dprior = got[0], got[4]
    pad = torch.from_numpy(kl.fwd.scatter < 0)
    assert not dfr[pad].any() and not dprior[pad].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [8, 48])
def test_scatter_matches_k6d_and_reference(C, dtype):
    """Values summed in float32, as K6d's one-hot matmul does for both
    types; the JAX fallback (``scatter_mm_reference``) sums bf16 values in
    bf16, so it is held at the bf16 tolerance."""
    tdt, jdt = DTYPES[dtype]
    kl, _, E = make_case(1, pad_rows=1)
    B, Fp = kl.fwd.scatter.shape
    vals = np.random.default_rng(7).standard_normal((B, Fp, C)).astype(np.float32)
    v = torch.from_numpy(vals).to(tdt)
    d = torch_layout(kl).fwd
    before = gs.scatter_launches
    got = gs.scatter_mm(v, d.scatter, d.chunk_tiles, E)
    assert gs.scatter_launches == before and got.dtype == torch.float32
    jargs = (jnp.asarray(vals, jdt), jnp.asarray(kl.fwd.scatter),
             jnp.asarray(kl.fwd.chunk_tiles), E)
    assert_close(got.numpy(), pm._scatter_mm_fwd_impl(*jargs, interpret=True))
    rel = 1e-5 if dtype == "float32" else 2e-2
    assert_close(got.numpy(), np.asarray(pm.scatter_mm_reference(*jargs),
                                         np.float32), rel, 1e-6)
    assert not got[-1].any()                    # batch-padding row


def test_scatter_gradient_matches_jax_grad_of_reference():
    kl, _, E = make_case(1)
    B, Fp = kl.fwd.scatter.shape
    vals = np.random.default_rng(8).standard_normal((B, Fp, 6)).astype(np.float32)
    sc, ct = jnp.asarray(kl.fwd.scatter), jnp.asarray(kl.fwd.chunk_tiles)
    want = jax.grad(lambda v: jnp.sum(jnp.sin(
        pm.scatter_mm_reference(v, sc, ct, E))))(jnp.asarray(vals))
    v = torch.from_numpy(vals).requires_grad_()
    d = torch_layout(kl).fwd
    torch.sin(gs.scatter_mm(v, d.scatter, d.chunk_tiles, E)).sum().backward()
    assert_close(v.grad.numpy(), want)
    assert not v.grad[torch.from_numpy(kl.fwd.scatter < 0)].any()


@pytest.mark.parametrize("apply_relu", [True, False])
def test_fused_autograd_fn_matches_autograd_of_plain_forward(apply_relu):
    """gate_scatter (FusedGateScatterFn: plain forward, plain backward on
    CPU) gives the gradients torch autograd takes through the plain
    forward, for all five differentiable inputs."""
    kl, x, E = proj_case(2, pad_rows=1)
    d = torch_layout(kl).fwd
    names = ("fact_rel", "w", "bias", "ins", "prior")

    def leaves():
        return {k: torch.from_numpy(x[k]).requires_grad_() for k in names}

    a = leaves()
    out = gs.gate_scatter(a["fact_rel"], a["w"], a["bias"], a["ins"],
                          a["prior"], d, E, apply_relu)
    B = out.shape[0]
    assert out.shape == (B, 2, E, 16)
    torch.sin(out).sum().backward()
    b = leaves()
    plain = gs.fused_gate_scatter_fwd_plain(*(b[k] for k in names), d.scatter,
                                            d.chunk_starts, apply_relu)
    torch.sin(plain.reshape(B, E, 2, 16).movedim(2, 1)).sum().backward()
    for k in names:
        assert_close(a[k].grad.numpy(), b[k].grad.numpy())


def test_scatter_autograd_fn_matches_autograd_of_plain_forward():
    kl, _, E = make_case(1, pad_rows=1)
    B, Fp = kl.fwd.scatter.shape
    vals = np.random.default_rng(9).standard_normal((B, Fp, 5)).astype(np.float32)
    d = torch_layout(kl).fwd
    a = torch.from_numpy(vals).requires_grad_()
    torch.cos(gs.scatter_mm(a, d.scatter, d.chunk_tiles, E)).sum().backward()
    b = torch.from_numpy(vals).requires_grad_()
    torch.cos(gs.scatter_mm_fwd_plain(b, d.scatter, d.chunk_tiles, E)).sum().backward()
    assert_close(a.grad.numpy(), b.grad.numpy())
