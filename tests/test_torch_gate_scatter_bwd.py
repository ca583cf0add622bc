"""The gate-scatter backward of gnn_rag_tpu_torch against the JAX package's
backward kernels.

``gate_scatter_bwd`` takes its plain PyTorch version on CPU tensors; here it
is held against the Pallas backward kernels run in interpret mode on the
same numpy inputs and a random cotangent: ``_fused_bwd_kernel_v4`` (K2,
through ``_v4_bwd_impl``), ``_fused_bwd_kernel_v4s`` (K3b, the same call with
the scoped-VMEM budget lowered so that the per-direction and the
per-instruction launches run) and ``_fused_bwd_kernel_v3`` (K4b, TypeLayer's
J=1 call without relu). Tolerance: max|got - ref| <= 1e-5 * max|ref| + 1e-6
in float32 (sums in another order: one-hot matmuls against einsums);
2e-2 * max|ref| for bfloat16 inputs. The CUDA kernel itself is compared with
the plain version on the card in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gate_scatter import assert_close, make_case, torch_layout

from gnn_rag_tpu.ops import pallas_mp as pm
from gnn_rag_tpu_torch.ops import gate_scatter as gs


def cotangent(kl, J, D, seed=5):
    rng = np.random.default_rng(seed)
    B = kl.fwd.scatter.shape[0]
    return rng.standard_normal((2, B, kl.num_entities, J * D)).astype(np.float32)


def port_bwd(kl, x, g, apply_relu, dtype=torch.float32, ndir=2, **kw):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    lay = torch_layout(kl)
    dirs = (lay.fwd, lay.inv)[:ndir]
    return gs.gate_scatter_bwd(
        (t["vals_f"].to(dtype), t["vals_i"].to(dtype))[:ndir],
        t["ins"].to(dtype), (t["prior_f"], t["prior_i"])[:ndir],
        tuple(d.scatter for d in dirs), tuple(d.chunk_starts for d in dirs),
        torch.from_numpy(g[:ndir]), apply_relu, **kw)


def jax_v4_bwd(kl, x, g, apply_relu, dtype=jnp.float32):
    ct2 = jnp.stack([jnp.asarray(kl.fwd.chunk_tiles),
                     jnp.asarray(kl.inv.chunk_tiles)], axis=1)
    return pm._v4_bwd_impl(
        jnp.asarray(x["vals_f"], dtype), jnp.asarray(x["vals_i"], dtype),
        jnp.asarray(x["ins"], dtype), jnp.asarray(x["prior_f"]),
        jnp.asarray(x["prior_i"]), jnp.asarray(kl.fwd.scatter),
        jnp.asarray(kl.inv.scatter), ct2, jnp.asarray(g[0]),
        jnp.asarray(g[1]), apply_relu, interpret=True)


def check_against_v4(got, want, rel=1e-5, abs_=1e-6):
    (dvf, dvi), (dpf, dpi), dins = got
    for name, a, b in zip(("dvals_f", "dvals_i", "dins", "dprior_f",
                           "dprior_i"), (dvf, dvi, dins, dpf, dpi), want):
        assert str(a.dtype) == f"torch.{b.dtype}", name
        assert_close(a.float().numpy(), np.asarray(b, np.float32), rel, abs_)


@pytest.mark.parametrize("J,apply_relu,pad_rows,empty_tile,skew", [
    (1, True, 1, False, False), (2, True, 1, False, False),
    (2, False, 1, False, False), (3, True, 1, False, False),
    (2, True, 0, True, False), (2, True, 1, False, True)])
def test_bwd_matches_v4_kernel(J, apply_relu, pad_rows, empty_tile, skew):
    """K2: both directions, with pad slots, the chunks past the last tile's
    range and a batch-padding row (all must get zero gradients); ``skew``:
    a layout whose first tile holds most chunks (E 512, 4 tiles)."""
    size = dict(E=512, F=1500) if skew else {}
    kl, x, E = make_case(J, B=1 if pad_rows else 2, pad_rows=pad_rows,
                         empty_tile=empty_tile, skew=skew, **size)
    if skew:
        counts = np.diff(kl.fwd.chunk_starts[0])
        assert counts[0] >= 4 and counts[0] > counts[1:].sum()
    g = cotangent(kl, J, 16)
    before = gs.bwd_launches
    got = port_bwd(kl, x, g, apply_relu)
    assert gs.bwd_launches == before          # CPU tensors run the plain version
    check_against_v4(got, jax_v4_bwd(kl, x, g, apply_relu))
    (dvf, dvi), (dpf, dpi), _ = got
    pad_f = torch.from_numpy(kl.fwd.scatter < 0)
    assert not dvf[pad_f].any() and not dpf[pad_f].any()
    assert not dvi[torch.from_numpy(kl.inv.scatter < 0)].any()
    if pad_rows:
        assert not dvf[-pad_rows:].any() and not dpi[-pad_rows:].any()


@pytest.mark.parametrize("J,D,limit_mb", [(2, 16, "0.3"), (3, 16, "0.3"),
                                          (3, 64, "0.3")])
def test_bwd_matches_v4s_tiers(J, D, limit_mb, monkeypatch):
    """K3b: with the VMEM budget lowered the JAX op launches one direction
    at a time (J=2, 3 at D=16) or one instruction at a time (J=3, D=64);
    the port has one kernel for every E and must give the same gradients."""
    monkeypatch.setenv("GNN_RAG_V4_VMEM_LIMIT_MB", limit_mb)
    kl, x, E = make_case(J, D=D, B=1, pad_rows=1)
    assert pm._v4_vmem_split(E, J, D)
    assert pm._v4s_fits(E, J, D) == (D == 16)    # per-direction vs per-j tier
    g = cotangent(kl, J, D)
    check_against_v4(port_bwd(kl, x, g, True), jax_v4_bwd(kl, x, g, True))


def test_bwd_matches_v3_kernel_type_layer():
    """K4b: TypeLayer's call, one direction, J=1, no relu, [B,J,E,D]
    cotangent."""
    kl, x, E = make_case(1, pad_rows=1)
    g = cotangent(kl, 1, 16)
    (dv,), (dp,), dins = port_bwd(kl, x, g, False, ndir=1)
    B = kl.fwd.scatter.shape[0]
    want_dv, want_dins, want_dp = pm._fused_v3_bwd_pallas_impl(
        jnp.asarray(x["vals_f"]), jnp.asarray(x["ins"]),
        jnp.asarray(x["prior_f"]), jnp.asarray(kl.fwd.scatter),
        jnp.asarray(kl.fwd.chunk_tiles),
        jnp.asarray(g[0]).reshape(B, E, 1, 16).transpose(0, 2, 1, 3), False,
        interpret=True)
    assert_close(dv.numpy(), want_dv)
    assert_close(dp.numpy(), want_dp)
    assert_close(dins.numpy(), want_dins)


def test_bwd_bf16_types_and_unrounded_prior():
    """bf16 inputs: dvals and dins come back in bf16, dprior in float32, and
    the prior multiplies unrounded, as in the TPU backward."""
    kl, x, E = make_case(2, B=1, pad_rows=1)
    g = cotangent(kl, 2, 16)
    got = port_bwd(kl, x, g, True, dtype=torch.bfloat16)
    check_against_v4(got, jax_v4_bwd(kl, x, g, True, jnp.bfloat16),
                     rel=2e-2, abs_=0.0)
    # the same call with the prior rounded to bf16 first differs in dvals
    # before their rounding to bf16: the port matches the unrounded form
    x_r = dict(x, prior_f=x["prior_f"].astype(jnp.bfloat16).astype(np.float32))
    (dv_r, _), _, _ = port_bwd(kl, x_r, g, True, dtype=torch.bfloat16)
    (dv, _), _, _ = got
    (dv32, _), _, _ = port_bwd(kl, {k: np.asarray(jnp.asarray(v, jnp.bfloat16),
                                                  np.float32)
                                    if k.startswith(("vals", "ins")) else v
                                    for k, v in x.items()}, g, True)
    assert torch.equal(dv, dv32.to(torch.bfloat16))
    assert not torch.equal(dv, dv_r)


@pytest.mark.parametrize("apply_relu", [True, False])
def test_autograd_fn_matches_autograd_of_plain_forward(apply_relu):
    """GateScatterFn on CPU tensors (plain forward, plain backward) gives the
    gradients torch autograd takes through the plain forward."""
    kl, x, E = make_case(2, pad_rows=1)
    lay = torch_layout(kl)

    def leaves():
        return {k: torch.from_numpy(v).requires_grad_() for k, v in x.items()}

    a = leaves()
    of, oi = gs.gate_scatter_both(a["vals_f"], a["vals_i"], a["ins"],
                                  a["prior_f"], a["prior_i"], lay, E, apply_relu)
    (torch.sin(of).sum() + torch.cos(oi).sum()).backward()
    b = leaves()
    out = gs.gate_scatter_fwd_plain(
        (b["vals_f"], b["vals_i"]), b["ins"], (b["prior_f"], b["prior_i"]),
        (lay.fwd.scatter, lay.inv.scatter),
        (lay.fwd.chunk_starts, lay.inv.chunk_starts), apply_relu)
    (torch.sin(out[0]).sum() + torch.cos(out[1]).sum()).backward()
    for k in x:
        assert_close(a[k].grad.numpy(), b[k].grad.numpy())


def test_autograd_fn_skips_unneeded_grads():
    """TypeLayer's call: unit instructions and mask priors need no gradient;
    the backward returns None for them and the same vals gradient."""
    kl, x, E = make_case(1, pad_rows=1)
    lay = torch_layout(kl)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    vals = t["vals_f"].clone().requires_grad_()
    ins = torch.ones_like(t["ins"])
    out = gs.gate_scatter_projected(vals, ins, t["prior_f"], lay.fwd, E,
                                    apply_relu=False)
    assert out.shape == (ins.shape[0], 1, E, 16)
    g = torch.from_numpy(cotangent(kl, 1, 16)[0])
    out.backward(g.reshape(-1, E, 1, 16).movedim(2, 1))
    (want,), dprior, dins = gs.gate_scatter_bwd(
        (t["vals_f"],), ins, (t["prior_f"],), (lay.fwd.scatter,),
        (lay.fwd.chunk_starts,), g[None], False, need_dprior=False,
        need_dins=False)
    assert dprior is None and dins is None
    assert torch.equal(vals.grad, want)
