"""The float32 flash kernels' arithmetic, emulated on the CPU.

On the card the float32 forward, dq and dk/dv kernels feed every float
operand x to the bf16 tensor cores as three terms, x1 = bf16(x), x2 =
bf16(x - x1), x3 = bf16(x - x1 - x2), and form x y as the six term
products whose indices add up to at most 4, the small ones first, summed
in float32 (csrc/flash_attention.cu, ``a_term`` / ``b_term``). Emulated
here with the same inputs from a numpy seed at (1, 300, 2, 128) float32:

* each product, in float64, is within 2^-21 sum |x y| of the exact one (the
  dropped x2y3, x3y2 and x3y3 are within ~2^-23 |x y|);
* the emulated o and lse (forward), dq (dq) and dk and dv (dk/dv), summed
  in float32, are within 0.1 of the card check's tolerance (1e-4 of
  max|plain|, chip_smoke.attn_err) of ``flash_fwd_plain``,
  ``flash_dq_plain`` and ``flash_dkv_plain``, which
  tests/test_torch_llm.py holds to the Pallas kernels in interpret mode.
"""

import math

import numpy as np
import pytest
import torch

from gnn_rag_tpu_torch.llm import flash_attention as fa

# (term of the left operand, term of the right one) in the order the
# kernels run them: the small products first
PAIRS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
SHAPE = (1, 300, 2, 128)


def terms(x):
    """x (float32) as its three bf16 terms, each widened to float32."""
    t1 = x.bfloat16().float()
    r1 = x - t1
    t2 = r1.bfloat16().float()
    return t1, t2, (r1 - t2).bfloat16().float()


def product(eq, x, y, dtype=torch.float32):
    """einsum ``eq`` of x and y as the six term products, summed in
    ``dtype`` in the kernels' order."""
    tx, ty = terms(x), terms(y)
    out = 0
    for a, b in PAIRS:
        out = out + torch.einsum(eq, tx[a].to(dtype), ty[b].to(dtype))
    return out


def inputs(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
            for _ in range(4)]


def forward_split3(q, k, v):
    """(o, lse, products): the forward with s = q k^T and o = p v as term
    products; ``products`` lists each (einsum, x, y) it formed."""
    B, L, H, D = q.shape
    s = product("blhd,bshd->bhls", q, k) / math.sqrt(D)
    keep = torch.arange(L)[None, :] <= torch.arange(L)[:, None]
    s = s.masked_fill(~keep, fa.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = product("bhls,bshd->bhld", p, v) / l
    products = (("blhd,bshd->bhls", q, k), ("bhls,bshd->bhld", p, v))
    return (o.transpose(1, 2), (m + torch.log(l)).reshape(B * H, L),
            products)


def dkv_split3(q, k, v, dout, lse, delta):
    """(dk, dv, products): s^T = k q^T, dp^T = v dO^T, dv = p^T dO and
    dk = ds^T q as term products, k and v the left operands as in the
    kernel."""
    B, L, H, D = q.shape
    scale = 1 / math.sqrt(D)
    st = product("bshd,blhd->bhsl", k, q) * scale
    keep = torch.arange(L)[:, None] <= torch.arange(L)[None, :]
    pt = torch.exp(st - lse.reshape(B, H, 1, L)) * keep
    dpt = product("bshd,blhd->bhsl", v, dout)
    dst = pt * (dpt - delta.reshape(B, H, 1, L)) * scale
    dv = product("bhsl,blhd->bshd", pt, dout)
    dk = product("bhsl,blhd->bshd", dst, q)
    products = (("bshd,blhd->bhsl", k, q), ("bshd,blhd->bhsl", v, dout),
                ("bhsl,blhd->bshd", pt, dout), ("bhsl,blhd->bshd", dst, q))
    return dk, dv, products


def dq_split3(q, k, v, dout, lse, delta):
    """(dq, products): s = q k^T, dp = dO v^T and dq = ds k as term
    products, q, dO and ds the left operands as in the kernel."""
    B, L, H, D = q.shape
    scale = 1 / math.sqrt(D)
    s = product("blhd,bshd->bhls", q, k) * scale
    keep = torch.arange(L)[None, :] <= torch.arange(L)[:, None]
    p = torch.exp(s - lse.reshape(B, H, L, 1)) * keep
    dp = product("blhd,bshd->bhls", dout, v)
    ds = p * (dp - delta.reshape(B, H, L, 1)) * scale
    dq = product("bhls,bshd->blhd", ds, k)
    products = (("blhd,bshd->bhls", q, k), ("blhd,bshd->bhls", dout, v),
                ("bhls,bshd->blhd", ds, k))
    return dq, products


def run(kernel, seed=5):
    """(emulated outputs, plain outputs, products) of one kernel."""
    q, k, v, g = inputs(seed)
    po, plse = fa.flash_fwd_plain(q, k, v)
    if kernel == "fwd":
        o, lse, products = forward_split3(q, k, v)
        return (o, lse), (po, plse), products
    delta = fa.bwd_delta(po, g)
    if kernel == "dq":
        dq, products = dq_split3(q, k, v, g, plse, delta)
        return (dq,), (fa.flash_dq_plain(q, k, v, g, plse, delta),), products
    dk, dv, products = dkv_split3(q, k, v, g, plse, delta)
    return (dk, dv), fa.flash_dkv_plain(q, k, v, g, plse, delta), products


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_six_term_products_keep_float32(kernel):
    """Each product of the kernel, formed from the three-term split in
    float64, is within 2^-21 sum |x y| of the exact float64 product."""
    _, _, products = run(kernel)
    for eq, x, y in products:
        got = product(eq, x, y, torch.float64)
        exact = torch.einsum(eq, x.double(), y.double())
        size = torch.einsum(eq, x.double().abs(), y.double().abs())
        assert bool(((got - exact).abs() <= 2 ** -21 * size).all()), eq


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_split3_outputs_within_a_tenth_of_the_card_tolerance(kernel):
    """The emulated kernel's outputs against the plain version's: within
    0.1 x 1e-4 of max|plain| (the card check holds the kernel to 1e-4)."""
    got, want, _ = run(kernel)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
        err = (a - b).abs().max().item()
        assert err <= 0.1 * 1e-4 * b.abs().max().item(), err
