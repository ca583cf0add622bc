"""gnn_rag_tpu_torch modules against their flax counterparts, with the flax
weights carried across by ``gnn_rag_tpu_torch.bridge``.

Every module gets the same numpy inputs in both packages; tolerance
max|got - ref| <= 1e-5 * max|ref| + 1e-6 in float32 (matmul and reduction
order differ between XLA and PyTorch on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rag_tpu.models import encoders as jenc
from gnn_rag_tpu.models.rearev import ReasonGNN as JReasonGNN
from gnn_rag_tpu.models.frozen_lm import FrozenLM as JFrozenLM
from gnn_rag_tpu.utils.synthetic import random_graph_batch
from gnn_rag_tpu_torch import bridge
from gnn_rag_tpu_torch.data.batch import GraphBatch
from gnn_rag_tpu_torch.data.kernel_layout import DirectionLayout, KernelLayout
from gnn_rag_tpu_torch.models import encoders as tenc
from gnn_rag_tpu_torch.models.frozen_lm import FrozenLM
from gnn_rag_tpu_torch.models.rearev import ReasonGNN

KEY = jax.random.PRNGKey(0)


def assert_close(got, ref, rel=1e-5, abs_=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max() + abs_, (err, np.abs(ref).max())


def bridged(module, params):
    module.load_state_dict(bridge.from_flax(params))  # strict: no leftovers
    return module.eval()


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def port_batch(jb) -> GraphBatch:
    """The port's GraphBatch over a JAX GraphBatch's numpy arrays."""
    names = [f.name for f in dataclasses.fields(GraphBatch) if f.name != "layout"]
    kl = jb.layout
    layout = None if kl is None else KernelLayout(
        DirectionLayout(*kl.fwd), DirectionLayout(*kl.inv), kl.num_entities)
    return GraphBatch(**{n: getattr(jb, n) for n in names}, layout=layout)


def test_attn_encoder_fusion_query_reform():
    rng = np.random.default_rng(0)
    D = 16
    x = rng.standard_normal((3, 5, D)).astype(np.float32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    m = jenc.AttnEncoder(D)
    p = m.init(KEY, x, mask)
    got = bridged(tenc.AttnEncoder(D), p)(t(x), t(mask))
    assert_close(got.detach().numpy(), m.apply(p, x, mask))

    q = rng.standard_normal((3, D)).astype(np.float32)
    ent = rng.standard_normal((3, 40, D)).astype(np.float32)
    seed = (rng.random((3, 40)) > 0.9).astype(np.float32)
    m = jenc.QueryReform(D)
    p = m.init(KEY, q, ent, seed)
    got = bridged(tenc.QueryReform(D), p)(t(q), t(ent), t(seed))
    assert_close(got.detach().numpy(), m.apply(p, q, ent, seed))


def test_instruction_decoder():
    rng = np.random.default_rng(1)
    D, J = 16, 3
    hid = rng.standard_normal((2, 7, D)).astype(np.float32)
    node = rng.standard_normal((2, D)).astype(np.float32)
    mask = np.ones((2, 7), np.float32)
    mask[1, 4:] = 0.0
    m = jenc.InstructionDecoder(D, J)
    p = m.init(KEY, hid, node, mask)
    want_ins, want_attn = m.apply(p, hid, node, mask)
    got_ins, got_attn = bridged(tenc.InstructionDecoder(D, J), p)(t(hid), t(node), t(mask))
    assert_close(got_ins.detach().numpy(), want_ins)
    assert_close(got_attn.detach().numpy(), want_attn)


def test_transformer_question_encoder_and_frozen_lm():
    rng = np.random.default_rng(2)
    kw = dict(vocab_size=100, hidden=32, layers=2, heads=4, intermediate=64,
              max_len=16)
    tok = rng.integers(3, 100, (3, 9)).astype(np.int32)
    tok[1, 5:] = 0
    mask = (tok != 0).astype(np.float32)
    m = jenc.TransformerQuestionEncoder(**kw)
    p = m.init(KEY, tok, mask)
    got = bridged(tenc.TransformerQuestionEncoder(**kw), p)(t(tok), t(mask))
    assert_close(got.detach().numpy(), m.apply(p, tok, mask))
    # the frozen-LM wrapper: same encode() contract, chunked over batches
    jlm = JFrozenLM(word_dim=32, vocab_size=100, layers=2, heads=4,
                    intermediate=64, max_len=16, params=p)
    tlm = FrozenLM(word_dim=32, vocab_size=100, layers=2, heads=4,
                   intermediate=64, max_len=16, state_dict=bridge.from_flax(p),
                   device="cpu")
    assert_close(tlm.encode(tok, batch=2), jlm.encode(tok, batch=2))
    # and back: to_flax inverts from_flax leaf for leaf
    back = bridge.to_flax(bridge.from_flax(p), heads=4)["params"]
    flat = jax.tree_util.tree_leaves_with_path(p["params"])
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_type_layer_layout_path():
    rng = np.random.default_rng(3)
    D, R = 16, 9
    jb = random_graph_batch(rng, batch_size=2, n_entities=256, n_facts=600,
                            num_relation=R, word_dim=None, build_layout=True)
    rel = rng.standard_normal((R + 1, D)).astype(np.float32)
    m = jenc.TypeLayer(D)
    args = (rel, jb.heads, jb.rels, jb.tails, jb.fact_mask, 256,
            jb.fact_rel_weight)
    p = m.init(KEY, *args, layout=jb.layout)
    want = m.apply(p, *args, layout=jb.layout)
    pb = port_batch(jb).to("cpu")
    got = bridged(tenc.TypeLayer(D, D), p)(t(rel), pb.layout, 256)
    assert_close(got.detach().numpy(), want)


@pytest.mark.parametrize("J,num_gnn", [(2, 2), (3, 1)])
def test_reason_gnn_stack(J, num_gnn):
    rng = np.random.default_rng(4)
    D, R, NE = 16, 9, 1000
    jb = random_graph_batch(rng, batch_size=2, n_entities=256, n_facts=600,
                            num_relation=R, num_entity_global=NE,
                            word_dim=None, build_layout=True)
    B, E = jb.seed_dist.shape
    ent = rng.standard_normal((B, E, D)).astype(np.float32)
    ins = rng.standard_normal((B, J, D)).astype(np.float32)
    rf = rng.standard_normal((R + 1, D)).astype(np.float32)
    rfi = rng.standard_normal((R + 1, D)).astype(np.float32)
    cand = jb.candidate_mask(NE)
    m = JReasonGNN(D, J, num_gnn, R + 1)
    args = (jb, ent, jb.seed_dist, ins, rf, rfi, cand, jb.fact_mask)
    p = m.init(KEY, *args)
    want_dist, want_emb = m.apply(p, *args)
    pb = port_batch(jb).to("cpu")
    mod = bridged(ReasonGNN(D, J, num_gnn), p)
    with torch.inference_mode():
        got_dist, got_emb = mod(pb, t(ent), pb.seed_dist, t(ins), t(rf), t(rfi),
                                pb.candidate_mask(NE))
    assert_close(got_emb.numpy(), want_emb)
    np.testing.assert_allclose(got_dist.numpy(), np.asarray(want_dist),
                               rtol=1e-4, atol=1e-6)


def test_bridge_rejects_unknown_leaves_and_init_scales_match_flax():
    with pytest.raises(KeyError):
        bridge.from_flax({"params": {"lstm": {"cell": {"kernel": np.zeros((2, 2))}}}})
    # ReaRev's pos_emb tables are ported: an Embed maps its embedding, and
    # a leaf no Embed has still raises
    assert set(bridge.from_flax(
        {"reasoning": {"pos_emb0": {"embedding": np.zeros((2, 2))}}})) == {
        "reasoning.pos_emb0.weight"}
    with pytest.raises(KeyError):
        bridge.from_flax({"reasoning": {"pos_emb0": {"kernel": np.zeros((2, 2))}}})
    # the port's seeded init draws from flax's families at flax's scales
    m = jenc.TransformerQuestionEncoder(vocab_size=3000, hidden=64, layers=1,
                                        heads=4, intermediate=256)
    p = m.init(KEY, np.zeros((1, 4), np.int32), np.ones((1, 4), np.float32))
    ref = bridge.from_flax(p)
    mine = tenc.flax_like_init_(
        tenc.TransformerQuestionEncoder(vocab_size=3000, hidden=64, layers=1,
                                        heads=4, intermediate=256),
        torch.Generator().manual_seed(0)).state_dict()
    assert set(mine) == set(ref)
    for name, r in ref.items():
        got = mine[name].float()
        assert got.shape == r.shape, name
        np.testing.assert_allclose(got.std().item() if got.numel() > 1 else 0.0,
                                   r.std().item() if r.numel() > 1 else 0.0,
                                   rtol=0.1, atol=1e-6, err_msg=name)
