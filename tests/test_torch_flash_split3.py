"""The float32 flash kernels' arithmetic, emulated on the CPU.

On the card the float32 forward, dq and dk/dv kernels feed every float
operand x to the bf16 tensor cores as three terms, x1 = bf16(x), x2 =
bf16(x - x1), x3 = bf16(x - x1 - x2), and form x y as the six term
products whose indices add up to at most 4, the small ones first, summed
in float32 (csrc/flash_attention.cu, ``a_term`` / ``b_term``). At head dims
256 to 1024 a cluster of D / 128 blocks (two to eight) splits the depth:
each block forms the six products over its 128 columns from zero, and the
blocks' partial scores (s, dp) are added in rank order, ((p0 + p1) + p2)
+ .. + p7 (at 256 the one sum of two; past four blocks the kernels add
rank by rank, the same order). Emulated here with the same inputs from a
numpy seed at (1, 300, 2, D) float32, D 128 to 1024, in the kernels'
tiles (the forward's online softmax over 64-key tiles, dq's 32-key tiles,
dk/dv's 32-row tiles, each tile's product added to a float32
accumulator):

* each product, in float64, is within 2^-21 sum |x y| of the exact one (the
  dropped x2y3, x3y2 and x3y3 are within ~2^-23 |x y|);
* the rank-order float32 sum of three to eight blocks' partial scores is
  within 2^-21 sum |x y| plus the rounding of the partials and of the
  D / 128 - 1 adds (2^-24 of each result's size) of the float64 score;
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
SHAPE = (1, 300, 2)               # B, L, H; then D
BLOCK_COLS = 128                  # the columns a block of the cluster owns
FWD_KEYS, DQ_KEYS, DKV_ROWS = 64, 32, 32     # the kernels' tiles


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The emulation's many small products run on one thread: with the
    suite's parallel workers, torch's default pool (a thread a core in
    every worker) oversubscribes the cores, and these tests ran ~100x
    slower than alone. The pool's size is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def inputs(seed, D):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((*SHAPE, D))
                             .astype(np.float32)) for _ in range(4)]


def partials(eq, x, y, dtype=torch.float32):
    """The cluster's partial scores of a score product (s, s^T, dp, dp^T:
    the depth summed), in rank order: six term products over block r's 128
    columns from zero, summed in ``dtype``."""
    return [product(eq, x[..., c:c + BLOCK_COLS], y[..., c:c + BLOCK_COLS],
                    dtype) for c in range(0, x.shape[-1], BLOCK_COLS)]


def scores(eq, x, y, products):
    """A score product as the kernels form it: the partials (D / 128: one
    at D 128, eight at 1024) added in rank order, ((p0 + p1) + p2) + ..;
    each block's product goes into ``products``."""
    out = None
    for c, part in zip(range(0, x.shape[-1], BLOCK_COLS),
                       partials(eq, x, y)):
        products.append((eq, x[..., c:c + BLOCK_COLS],
                         y[..., c:c + BLOCK_COLS]))
        out = part if out is None else out + part
    return out


def tiled(eq, x, y, axis_x, axis_y, size, products):
    """An output product (o, dq, dk, dv: keys or query rows summed) over
    tiles of ``size`` along the summed axis (``axis_x`` of x, ``axis_y`` of
    y), each tile's six term products added to a float32 accumulator in
    tile order."""
    products.append((eq, x, y))
    out = 0
    for i in range(0, x.shape[axis_x], size):
        out = out + product(eq, x.narrow(axis_x, i, min(size, x.shape[axis_x] - i)),
                            y.narrow(axis_y, i, min(size, y.shape[axis_y] - i)))
    return out


def forward_split3(q, k, v):
    """(o, lse, products): the forward with s = q k^T and o = p v as term
    products, the online softmax over 64-key tiles; ``products`` lists each
    (einsum, x, y) it formed."""
    B, L, H, D = q.shape
    products = []
    s = scores("blhd,bshd->bhls", q, k, products) / math.sqrt(D)
    keep = torch.arange(L)[None, :] <= torch.arange(L)[:, None]
    s = s.masked_fill(~keep, fa.NEG_INF)
    m = torch.full((B, H, L, 1), fa.NEG_INF)
    l = torch.zeros((B, H, L, 1))
    o = torch.zeros((B, H, L, D))
    ps = []
    for k0 in range(0, L, FWD_KEYS):
        st = s[..., k0:k0 + FWD_KEYS]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + product("bhls,bshd->bhld", p, v[:, k0:k0 + FWD_KEYS])
        m = m_new
        ps.append(torch.exp(st - m_new))
    products.append(("bhls,bshd->bhld", torch.cat(ps, -1), v))
    return (o.transpose(1, 2) / l.transpose(1, 2),
            (m + torch.log(l)).reshape(B * H, L), products)


def dkv_split3(q, k, v, dout, lse, delta):
    """(dk, dv, products): s^T = k q^T, dp^T = v dO^T, dv = p^T dO and
    dk = ds^T q as term products over 32-row tiles, k and v the left
    operands as in the kernel."""
    B, L, H, D = q.shape
    scale = 1 / math.sqrt(D)
    products = []
    st = scores("bshd,blhd->bhsl", k, q, products) * scale
    keep = torch.arange(L)[:, None] <= torch.arange(L)[None, :]
    pt = torch.exp(st - lse.reshape(B, H, 1, L)) * keep
    dpt = scores("bshd,blhd->bhsl", v, dout, products)
    dst = pt * (dpt - delta.reshape(B, H, 1, L)) * scale
    dv = tiled("bhsl,blhd->bshd", pt, dout, 3, 1, DKV_ROWS, products)
    dk = tiled("bhsl,blhd->bshd", dst, q, 3, 1, DKV_ROWS, products)
    return dk, dv, products


def dq_split3(q, k, v, dout, lse, delta):
    """(dq, products): s = q k^T, dp = dO v^T and dq = ds k as term
    products over 32-key tiles, q, dO and ds the left operands as in the
    kernel."""
    B, L, H, D = q.shape
    scale = 1 / math.sqrt(D)
    products = []
    s = scores("blhd,bshd->bhls", q, k, products) * scale
    keep = torch.arange(L)[None, :] <= torch.arange(L)[:, None]
    p = torch.exp(s - lse.reshape(B, H, L, 1)) * keep
    dp = scores("blhd,bshd->bhls", dout, v, products)
    ds = p * (dp - delta.reshape(B, H, L, 1)) * scale
    dq = tiled("bhls,bshd->blhd", ds, k, 3, 1, DQ_KEYS, products)
    return dq, products


def run(kernel, D, seed=5):
    """(emulated outputs, plain outputs, products) of one kernel."""
    q, k, v, g = inputs(seed, D)
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


# the float32 kernels' head dims: clusters of D / 128 blocks, one to eight
HEAD_DIMS = [128, 256, 384, 512, 640, 768, 896, 1024]


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_six_term_products_keep_float32(kernel, D):
    """Each product of the kernel, formed from the three-term split in
    float64, is within 2^-21 sum |x y| of the exact float64 product."""
    _, _, products = run(kernel, D)
    for eq, x, y in products:
        got = product(eq, x, y, torch.float64)
        exact = torch.einsum(eq, x.double(), y.double())
        size = torch.einsum(eq, x.double().abs(), y.double().abs())
        assert bool(((got - exact).abs() <= 2 ** -21 * size).all()), eq


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_split3_outputs_within_a_tenth_of_the_card_tolerance(kernel, D):
    """The emulated kernel's outputs against the plain version's: within
    0.1 x 1e-4 of max|plain| (the card check holds the kernel to 1e-4)."""
    got, want, _ = run(kernel, D)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
        err = (a - b).abs().max().item()
        assert err <= 0.1 * 1e-4 * b.abs().max().item(), err


@pytest.mark.parametrize("D", [384, 512, 640, 768, 896, 1024])
def test_rank_order_sum_of_partials_within_float_rounding(D):
    """The score of a cluster of D / 128 blocks, q k^T as the rank-order
    float32 sum ((p0 + p1) + p2) + .. of the blocks' float32 partials,
    against the float64 product: within the six products' 2^-21 sum |q k|
    (each partial's terms formed in float64) plus one float rounding (2^-24)
    of each partial and of each add's result, bounded by sum_r |p_r|. The
    sum in another order (block r's own partial first, r >= 2: for r = 1
    the first add commutes) differs in some bits: every block has to add in
    the same order to hold the same s."""
    q, k, _, _ = inputs(11, D)
    eq = "blhd,bshd->bhls"
    exact = torch.einsum(eq, q.double(), k.double())
    size = torch.einsum(eq, q.double().abs(), k.double().abs())
    parts = partials(eq, q, k)
    assert len(parts) == D // BLOCK_COLS
    got = parts[0]
    for part in parts[1:]:
        got = got + part
    assert torch.equal(got, scores(eq, q, k, []))
    rounding = 2.0 ** -24 * (2 * len(parts) - 1) * sum(
        p.double().abs() for p in parts)
    assert bool(((got.double() - exact).abs()
                 <= 2 ** -21 * size + rounding).all())
    for own in range(2, len(parts)):
        other = parts[own]
        for r, part in enumerate(parts):
            if r != own:
                other = other + part
        assert not torch.equal(other, got), own
