"""ReaRev's options in gnn_rag_tpu_torch against the JAX package, each
through both packages' Trainers (the port's builds the model for the inputs
it is given): the LSTM question encoder with and without a frozen word
table, the in-model transformer of ``lm_frozen 0`` seeded by
``Trainer.seed_submodule``, ``pos_emb`` (its COO steps beside TypeLayer's
layout launch), ``normalized_gnn`` on the layout path and on the COO path,
``norm_rel``, a frozen KG entity table, a frozen KG relation table and the
trainable relation tables (relation texts off). Each case: the loss, the
answer distribution and every parameter gradient of one training-mode
batch with a padding row, the flax weights carried across by
``gnn_rag_tpu_torch.bridge``.

Tolerances (those of tests/test_torch_train.py): loss rtol 1e-5; each
gradient max|got - ref| <= 1e-4 * max|ref| + 1e-7; the distribution atol
1e-6, rtol 1e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_retrievers import assert_close, write_rich_dataset

from gnn_rag_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from gnn_rag_tpu.data import loader as jloader
from gnn_rag_tpu.models import encoders as jenc
from gnn_rag_tpu.train.trainer import Trainer as JTrainer
from gnn_rag_tpu.utils.synthetic import random_rel_hidden
from gnn_rag_tpu_torch import bridge, cli
from gnn_rag_tpu_torch.data import loader
from gnn_rag_tpu_torch.train.trainer import Trainer

KEY = jax.random.PRNGKey(0)
WORD_DIM = 32
# the in-model transformer at a test width (the CLI pins lm_spec from the
# loaded encoder the same way): vocab, hidden, layers, heads, intermediate,
# max_len, positions, pad id
LM_SPEC = (30522, WORD_DIM, 1, 2, 64, 64, "bert", 0)

CASES = {
    "lstm": dict(lm="lstm"),
    "lstm_word_emb": dict(lm="lstm", word_emb=True),
    "lm_frozen0_seeded": dict(lm_frozen=False),
    "pos_emb": dict(pos_emb=True),
    "normalized_gnn_layout": dict(normalized_gnn=True),
    "normalized_gnn_coo": dict(normalized_gnn=True, coo=True),
    "norm_rel": dict(norm_rel=True),
    "entity_emb": dict(entity_emb=True),
    "relation_emb": dict(rel_text=False, relation_emb=True),
    "relation_tables": dict(rel_text=False),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("options")
    write_rich_dataset(root)
    rng = np.random.default_rng(4)
    np.save(root / "relation_emb.npy",
            rng.standard_normal((3, 6)).astype(np.float32))
    return root


@pytest.mark.parametrize("case", list(CASES))
def test_option_matches_jax(data, case):
    opt = dict(CASES[case])
    coo, rel_text = opt.pop("coo", False), opt.pop("rel_text", True)
    use_word_emb, use_entity_emb, use_relation_emb = (
        opt.pop(k, False) for k in ("word_emb", "entity_emb", "relation_emb"))
    lm = opt.pop("lm", "sbert")
    inmodel = opt.get("lm_frozen") is False
    cfg = Config(
        data=DataConfig(name="webqsp", data_folder=str(data) + "/", lm=lm,
                        relation_word_emb=rel_text),
        model=ModelConfig(entity_dim=16, num_iter=2, num_ins=2, num_gnn=2,
                          lm=lm, word_dim=12, kg_dim=8, linear_dropout=0.0,
                          lm_dropout=0.0, lm_spec=LM_SPEC if inmodel else None,
                          **opt),
        train=TrainConfig(is_eval=False, batch_size=4, checkpoint_dir=str(data)))
    jb, tb = jloader.load_dataset_dir(cfg), loader.load_dataset_dir(cfg)
    nkr, vocab = tb["num_kb_relation"], tb["vocab"]
    rng = np.random.default_rng(0)
    rel = random_rel_hidden(rng, nkr + 1, 4, WORD_DIM) if rel_text else (None,) * 3
    if lm != "lstm" and not inmodel:      # frozen-LM question states
        hid = [rng.standard_normal((len(r.q_token_ids), WORD_DIM)).astype(np.float32)
               for r in tb["train"].records]
        jb["train"].q_hidden = tb["train"].q_hidden = hid
    tables = dict(
        entity_emb=(np.pad(rng.standard_normal((vocab.num_entity, 8)),
                           ((0, 1), (0, 0))).astype(np.float32)
                    if use_entity_emb else None),
        word_emb=None, relation_emb=None)
    if use_word_emb:
        np.save(data / "word_emb.npy", rng.standard_normal(
            (len(vocab.word2id), 10)).astype(np.float32))
        tables["word_emb"] = cli.load_padded(str(data), "word_emb.npy")
    if use_relation_emb:
        args = (str(data / "relation_emb.npy"), nkr, False, True)
        tables["relation_emb"] = loader.load_relation_emb(*args)
        np.testing.assert_array_equal(tables["relation_emb"],
                                      jloader.load_relation_emb(*args))
    common = dict(valid_data=None, test_data=None, num_entity=vocab.num_entity,
                  num_kb_relation=nkr, num_word=len(vocab.word2id),
                  rel_hidden=rel[0], rel_hidden_inv=rel[1], rel_text_mask=rel[2],
                  **tables)
    jtr = JTrainer(cfg, train_data=jb["train"], **common)
    tr = Trainer(cfg, train_data=tb["train"], device="cpu", **common)
    tr.model.load_state_dict(bridge.from_flax(jtr.params))
    if inmodel:
        # both start the in-model LM from the same encoder weights
        enc = jenc.TransformerQuestionEncoder(
            **dict(zip(("vocab_size", "hidden", "layers", "heads", "intermediate",
                        "max_len", "position_style", "pad_idx"), LM_SPEC)))
        seed = jax.jit(enc.init)(jax.random.PRNGKey(7), np.zeros((1, 4), np.int32),
                                 np.ones((1, 4), np.float32))
        jtr.seed_submodule("lm", seed)
        tr.seed_submodule("lm", bridge.from_flax(seed))
        got = tr.model.state_dict()
        for n, w in bridge.from_flax(seed).items():
            assert torch.equal(got["lm." + n], w), n
        with pytest.raises(ValueError, match="shape mismatch"):
            tr.seed_submodule("lm", {"tok_emb.weight": torch.zeros(3, 3)})

    idx = [0, 1, 2, 3]
    jbatch = jb["train"].make_batch(idx, build_layout=not coo, batch_pad_to=5)
    tbatch = tb["train"].make_batch(idx, batch_pad_to=5).to("cpu")
    if coo:
        tbatch = dataclasses.replace(tbatch, layout=None)

    def loss_fn(p):
        loss, _, dist = jtr.model.apply(p, jbatch, *jtr.rel_args, training=True,
                                        rngs={"dropout": KEY})
        return loss, dist

    (want_loss, want_dist), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jtr.params)
    loss, _, dist = tr.model(tbatch, *tr.rel_args, training=True,
                             generator=tr.generator)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(dist.detach().numpy(), np.asarray(want_dist),
                               atol=1e-6, rtol=1e-4)
    want = bridge.from_flax(jgrads)
    params = dict(tr.model.named_parameters())
    assert set(want) == set(params)
    for name, g in want.items():
        assert_close(params[name].grad.numpy(), g.numpy(), 1e-4, 1e-7, name)
    # the option's own parameters exist (and nothing else changed shape)
    own = {"lstm": "instruction_encoder.lstm.weight_ih_l0",
           "lstm_word_emb": "instruction_encoder.lstm.weight_ih_l0",
           "lm_frozen0_seeded": "lm.ffn1_0.weight",
           "pos_emb": "reasoning.pos_emb_inv1.weight",
           "entity_emb": "entity_linear.weight",
           "relation_emb": "relation_linear_inv_proj.weight",
           "relation_tables": "relation_embedding_inv.weight"}.get(case)
    assert own is None or own in params
    assert ("instruction_encoder.word_embedding.weight" in params) == (case == "lstm")
    tr.close()
