"""gnn_rag_tpu_torch ops against the JAX package's ops.

The port's gate-scatter wrappers (``gate_scatter_both``, the v4 op;
``gate_scatter_projected``, the v3 op) take their plain PyTorch version on
CPU tensors; here they are held against the Pallas kernels run in interpret
mode and against the XLA references, on the same numpy inputs. Tolerance:
max|got - ref| <= 1e-5 * max|ref| + 1e-6 in float32 (the sums run in another
order: index_add against one-hot matmuls / segment sums).
The CUDA kernel itself is compared with the plain version on the card in
test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rag_tpu.data import kernel_layout as jkl
from gnn_rag_tpu.ops import pallas_mp as pm
from gnn_rag_tpu.ops import segment as jseg
from gnn_rag_tpu.ops.softmax import masked_softmax as jax_masked_softmax
from gnn_rag_tpu_torch.data import kernel_layout as tkl
from gnn_rag_tpu_torch.ops import gate_scatter as gs
from gnn_rag_tpu_torch.ops import segment as tseg
from gnn_rag_tpu_torch.ops.softmax import masked_softmax


def assert_close(got, ref, rel=1e-5, abs_=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= rel * np.abs(ref).max() + abs_, (err, np.abs(ref).max())


def make_case(J, *, D=16, E=256, B=2, F=300, pad_rows=0, empty_tile=False,
              seed=0, skew=False):
    """Random facts -> both packages' layouts (must agree) and gate inputs.
    ``skew``: each tail drawn as E u^4 (u uniform), so the first tile holds
    most of the forward direction's chunks."""
    rng = np.random.default_rng(seed)
    heads = rng.integers(0, E, (B, F)).astype(np.int32)
    tails = rng.integers(0, E, (B, F)).astype(np.int32)
    if skew:
        tails = (E * rng.random((B, F)) ** 4).astype(np.int32)
    if empty_tile:  # sample 0 touches only the first tile
        heads[0] %= tkl.TILE_E
        tails[0] %= tkl.TILE_E
    rels = rng.integers(0, 4, (B, F)).astype(np.int32)
    keep = rng.random((B, F)) > 0.15
    w = rng.random((B, F)).astype(np.float32)
    empty = np.zeros(0, np.int32)
    layouts = []
    for mod in (tkl, jkl):
        fwd = [mod.build_sample_direction(tails[b][keep[b]], heads[b][keep[b]],
                                          rels[b][keep[b]], w[b][keep[b]], E, 4)
               for b in range(B)]
        inv = [mod.build_sample_direction(heads[b][keep[b]], tails[b][keep[b]],
                                          rels[b][keep[b]], w[b][keep[b]], E, 4)
               for b in range(B)]
        pad = mod.build_sample_direction(empty, empty, empty,
                                         np.zeros(0, np.float32), E, 4)
        fwd += [pad] * pad_rows
        inv += [pad] * pad_rows
        nc = max(len(s[4]) for s in fwd + inv) + 1
        layouts.append(mod.pack_samples(fwd, inv, E, 4, num_chunks=-(-nc // 8) * 8))
    kl, jl = layouts
    for a, b in zip(list(kl.fwd) + list(kl.inv), list(jl.fwd) + list(jl.inv)):
        np.testing.assert_array_equal(a, b)
    Bp, Fp = kl.fwd.scatter.shape
    x = dict(
        vals_f=rng.standard_normal((Bp, Fp, D)).astype(np.float32),
        vals_i=rng.standard_normal((Bp, Fp, D)).astype(np.float32),
        ins=rng.standard_normal((Bp, J, D)).astype(np.float32),
        prior_f=(rng.random((Bp, Fp)) * (kl.fwd.scatter >= 0)).astype(np.float32),
        prior_i=(rng.random((Bp, Fp)) * (kl.inv.scatter >= 0)).astype(np.float32))
    return kl, x, E


def torch_layout(kl, device="cpu"):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return tkl.KernelLayout(fwd=tkl.DirectionLayout(*map(t, kl.fwd)),
                            inv=tkl.DirectionLayout(*map(t, kl.inv)),
                            num_entities=kl.num_entities)


def port_both(kl, x, E, apply_relu, device="cpu", dtype=torch.float32):
    t = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    return gs.gate_scatter_both(
        t["vals_f"].to(dtype), t["vals_i"].to(dtype), t["ins"].to(dtype),
        t["prior_f"], t["prior_i"], torch_layout(kl, device), E, apply_relu)


# a skewed layout (E 512, 4 tiles) whose first forward tile holds at least
# 9 chunks: the regime where the card's kernel splits a tile over blocks
SKEWED = dict(E=512, F=2000, skew=True)


def skewed_case(J):
    kl, x, E = make_case(J, **SKEWED)
    counts = np.diff(kl.fwd.chunk_starts, axis=1)
    assert counts.max() >= 9 and counts[:, 0].min() > counts[:, 1:].max()
    return kl, x, E


@pytest.mark.parametrize("J,apply_relu,pad_rows,empty_tile,skew", [
    (1, True, 0, False, False), (2, True, 0, False, False),
    (2, False, 0, False, False), (3, True, 0, False, False),
    (2, True, 2, False, False), (2, True, 0, True, False),
    (2, True, 0, False, True), (3, True, 0, False, True)])
def test_both_matches_v4_kernel_and_reference(J, apply_relu, pad_rows,
                                              empty_tile, skew):
    kl, x, E = (skewed_case(J) if skew else
                make_case(J, pad_rows=pad_rows, empty_tile=empty_tile))
    before = gs.launches
    got_f, got_i = port_both(kl, x, E, apply_relu)
    assert gs.launches == before  # CPU tensors run the plain version
    ct2 = jnp.stack([jnp.asarray(kl.fwd.chunk_tiles),
                     jnp.asarray(kl.inv.chunk_tiles)], axis=1)
    args = (jnp.asarray(x["vals_f"]), jnp.asarray(x["vals_i"]),
            jnp.asarray(x["ins"]), jnp.asarray(x["prior_f"]),
            jnp.asarray(x["prior_i"]), jnp.asarray(kl.fwd.scatter),
            jnp.asarray(kl.inv.scatter), ct2, E, apply_relu)
    for want_f, want_i in (pm._v4_fwd_impl(*args, interpret=True),
                           pm.gated_scatter_v4_reference(*args)):
        assert_close(got_f.numpy(), want_f)
        assert_close(got_i.numpy(), want_i)
    if pad_rows:
        assert not got_f[-pad_rows:].any() and not got_i[-pad_rows:].any()
    if empty_tile:
        assert not got_f[0, tkl.TILE_E:].any()


@pytest.mark.parametrize("J,apply_relu,skew", [
    (1, False, False), (2, True, False), (2, False, False), (1, False, True)])
def test_projected_matches_v3_kernel(J, apply_relu, skew):
    kl, x, E = skewed_case(J) if skew else make_case(J)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    got = gs.gate_scatter_projected(t["vals_f"], t["ins"], t["prior_f"],
                                    torch_layout(kl).fwd, E, apply_relu)
    args = (jnp.asarray(x["vals_f"]), jnp.asarray(x["ins"]),
            jnp.asarray(x["prior_f"]), jnp.asarray(kl.fwd.scatter),
            jnp.asarray(kl.fwd.chunk_tiles), E, apply_relu)
    assert got.shape == (x["ins"].shape[0], J, E, x["vals_f"].shape[-1])
    assert_close(got.numpy(), pm._fused_v3_fwd_impl(*args, interpret=True))
    assert_close(got.numpy(), pm.gated_scatter_v3_reference(*args))


def test_huge_entity_tier_matches_reference():
    """E=8192, J=3: the shape the TPU's per-instruction launch tier exists
    for; one GPU kernel covers it."""
    kl, x, E = make_case(3, D=8, E=8192, B=1, F=3000, seed=1)
    got_f, got_i = port_both(kl, x, E, True)
    ct2 = jnp.stack([jnp.asarray(kl.fwd.chunk_tiles),
                     jnp.asarray(kl.inv.chunk_tiles)], axis=1)
    want_f, want_i = pm.gated_scatter_v4_reference(
        jnp.asarray(x["vals_f"]), jnp.asarray(x["vals_i"]),
        jnp.asarray(x["ins"]), jnp.asarray(x["prior_f"]),
        jnp.asarray(x["prior_i"]), jnp.asarray(kl.fwd.scatter),
        jnp.asarray(kl.inv.scatter), ct2, E, True)
    assert_close(got_f.numpy(), want_f)
    assert_close(got_i.numpy(), want_i)


def test_segment_ops_and_softmax_match_jax():
    rng = np.random.default_rng(3)
    B, E, F, D = 2, 256, 300, 5
    ent2 = rng.standard_normal((B, E)).astype(np.float32)
    ent3 = rng.standard_normal((B, E, D)).astype(np.float32)
    idx = rng.integers(0, E, (B, F)).astype(np.int32)
    vals = rng.standard_normal((B, F, D)).astype(np.float32)
    t = torch.from_numpy
    assert_close(tseg.gather_entities_to_facts(t(ent2), t(idx)).numpy(),
                 jseg.gather_entities_to_facts(jnp.asarray(ent2), jnp.asarray(idx)))
    assert_close(tseg.gather_entities_to_facts(t(ent3), t(idx)).numpy(),
                 jseg.gather_entities_to_facts(jnp.asarray(ent3), jnp.asarray(idx)))
    for v in (vals, vals[..., 0]):
        assert_close(tseg.batched_segment_sum(t(np.ascontiguousarray(v)), t(idx), E).numpy(),
                     jseg.batched_segment_sum(jnp.asarray(v), jnp.asarray(idx), E))
    kl, _, _ = make_case(2)
    keep = (rng.random((2, 300)) > 0.3).astype(np.float32)
    assert_close(tseg.layout_fact_keep(torch_layout(kl).fwd, t(keep)).numpy(),
                 jseg.layout_fact_keep(kl.fwd, jnp.asarray(keep)))
    mask = (rng.random((B, E)) > 0.5).astype(np.float32)
    assert_close(masked_softmax(t(ent2) * 30, t(mask), dim=1).numpy(),
                 jax_masked_softmax(jnp.asarray(ent2) * 30, jnp.asarray(mask), axis=1))
