"""The gnn_rag_tpu_torch serving slice against the JAX package, end to end:
loader batches, the ReaRev forward (loss, pred_dist, argmax), the
Evaluator's `.info` lines and RetrieverService.retrieve, with the flax
weights carried across by ``gnn_rag_tpu_torch.bridge``."""

import json

import jax
import numpy as np
import pytest
import torch
from test_cli_e2e import write_micro_dataset
from test_serve import make_question

from gnn_rag_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from gnn_rag_tpu.data.loader import load_dataset_dir as jax_load_dataset_dir
from gnn_rag_tpu.models import ReaRev as JReaRev
from gnn_rag_tpu.serve import RetrieverService as JRetrieverService
from gnn_rag_tpu.train.evaluate import Evaluator as JEvaluator
from gnn_rag_tpu.utils.synthetic import random_rel_hidden
from gnn_rag_tpu_torch import bridge
from gnn_rag_tpu_torch.data.loader import load_dataset_dir
from gnn_rag_tpu_torch.data.vocab import Vocab
from gnn_rag_tpu_torch.models.rearev import ReaRev
from gnn_rag_tpu_torch.serve import RetrieverService
from gnn_rag_tpu_torch.train.evaluate import Evaluator
from gnn_rag_tpu_torch.train.trainer import build_model

WORD_DIM = 32


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """Micro dataset loaded by both packages, shared frozen-LM states and
    one set of flax weights bridged into the port's ReaRev."""
    root = tmp_path_factory.mktemp("micro")
    write_micro_dataset(root)
    cfg = Config(data=DataConfig(name="webqsp", data_folder=str(root) + "/"),
                 model=ModelConfig(entity_dim=16, num_iter=2, num_ins=2,
                                   num_gnn=2, linear_dropout=0.0),
                 train=TrainConfig(is_eval=False))
    jb, tb = jax_load_dataset_dir(cfg), load_dataset_dir(cfg)
    nkr = tb["num_kb_relation"]
    rng = np.random.default_rng(0)
    rel = random_rel_hidden(rng, nkr + 1, 4, WORD_DIM)
    for split in ("train", "valid", "test"):
        hid = [rng.standard_normal((len(r.q_token_ids), WORD_DIM)).astype(np.float32)
               for r in tb[split].records]
        jb[split].q_hidden = tb[split].q_hidden = hid
    num_entity = tb["vocab"].num_entity
    jmodel = JReaRev(cfg=cfg.model, num_entity=num_entity, num_relation=nkr)
    jbatch = jb["train"].make_batch(range(4), build_layout=True)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch, *rel)
    model = ReaRev(cfg.model, num_entity, nkr, WORD_DIM)
    model.load_state_dict(bridge.from_flax(params))
    return dict(cfg=cfg, jb=jb, tb=tb, rel=rel, jmodel=jmodel, params=params,
                model=model.eval(), num_entity=num_entity)


def test_loader_builds_the_same_batches(micro):
    jbatch = micro["jb"]["train"].make_batch(range(8), build_layout=True,
                                             batch_pad_to=10)
    tbatch = micro["tb"]["train"].make_batch(range(8), batch_pad_to=10)
    for name in ("heads", "rels", "tails", "fact_mask", "entity_gids",
                 "seed_dist", "query_entities", "answer_dist", "q_tokens",
                 "q_mask", "q_hidden", "fact_rel_weight"):
        np.testing.assert_array_equal(getattr(tbatch, name), getattr(jbatch, name),
                                      err_msg=name)
    for a, b in zip(list(tbatch.layout.fwd) + list(tbatch.layout.inv),
                    list(jbatch.layout.fwd) + list(jbatch.layout.inv)):
        np.testing.assert_array_equal(a, b)


def test_forward_matches_jax(micro):
    idx = list(range(8))
    jbatch = micro["jb"]["train"].make_batch(idx, build_layout=True)
    want_loss, want_pred, want_dist = micro["jmodel"].apply(
        micro["params"], jbatch, *micro["rel"])
    tbatch = micro["tb"]["train"].make_batch(idx).to("cpu")
    with torch.inference_mode():
        loss, pred, dist = micro["model"](tbatch, *map(torch.from_numpy, micro["rel"]))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(dist.numpy(), np.asarray(want_dist),
                               atol=1e-6, rtol=1e-4)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(want_pred))
    assert float(loss) > 0 and np.allclose(dist.sum(1).numpy(), 1.0, rtol=1e-5)


def test_evaluator_info_lines_match_jax(micro, tmp_path):
    cfg, rel = micro["cfg"], micro["rel"]
    vocab = micro["tb"]["vocab"]
    kw = dict(eps=cfg.model.eps, num_entity=micro["num_entity"],
              id2entity=vocab.id2entity, num_iter=cfg.model.num_iter)
    jfwd = jax.jit(lambda b: micro["jmodel"].apply(micro["params"], b, *rel))
    want = JEvaluator(**kw).evaluate(
        micro["jb"]["train"], jfwd, test_batch_size=4, write_info=True,
        info_path=str(tmp_path / "jax.info"), build_layout=True)
    rel_t = tuple(map(torch.from_numpy, rel))
    got = Evaluator(**kw).evaluate(
        micro["tb"]["train"], lambda b: micro["model"](b.to("cpu"), *rel_t),
        test_batch_size=4, write_info=True, info_path=str(tmp_path / "port.info"))
    np.testing.assert_allclose(got[:3], want, rtol=1e-6)
    jl = [json.loads(x) for x in open(tmp_path / "jax.info")]
    tl = [json.loads(x) for x in open(tmp_path / "port.info")]
    assert len(tl) == len(jl) == 8
    for a, b in zip(tl, jl):
        assert list(a) == list(b)           # same keys, same order ("precison")
        for k in ("question", "answers", "hit", "em", "f1", "precison", "recall"):
            assert a[k] == b[k], k
        assert [c for c, _ in a["cand"]] == [c for c, _ in b["cand"]]
        np.testing.assert_allclose([p for _, p in a["cand"]],
                                   [p for _, p in b["cand"]], atol=1e-5)


def test_retrieve_matches_jax():
    """RetrieverService.retrieve in both packages on the serving test's
    question: same candidates in the same order, same verbalized paths."""
    ents = {f"m.{i:02d}": i for i in range(20)}
    rels = {"people.person.place_of_birth": 0, "location.location.contains": 1}
    cfg = Config(data=DataConfig(name="webqsp"),
                 model=ModelConfig(entity_dim=16, num_iter=1, num_ins=2,
                                   num_gnn=1, linear_dropout=0.0))
    rng = np.random.default_rng(0)
    rel_h, rel_hinv, rel_mask = random_rel_hidden(rng, 3 + 1, 4, WORD_DIM)

    def qenc(token_ids):
        r = np.random.default_rng(int(token_ids.sum()))
        return r.standard_normal((len(token_ids), WORD_DIM)).astype(np.float32)

    from gnn_rag_tpu.data.loader import KGQADataset, ingest_question
    from gnn_rag_tpu.data.vocab import Vocab as JVocab
    jvocab = JVocab(ents, rels, {})
    rec = ingest_question(make_question(), jvocab, data_name="webqsp",
                          use_inverse_relation=False, use_self_loop=True,
                          num_kb_relation=3)
    ds = KGQADataset([rec], num_entity=20, num_kb_relation=3)
    rec.q_token_ids = np.zeros(4, np.int32)
    ds.q_hidden = [qenc(rec.q_token_ids)]
    jmodel = JReaRev(cfg=cfg.model, num_entity=20, num_relation=3)
    params = jmodel.init(jax.random.PRNGKey(0), ds.make_batch([0]),
                         rel_h, rel_hinv, rel_mask)
    jsvc = JRetrieverService(cfg, jvocab, params, rel_hidden=rel_h,
                             rel_hidden_inv=rel_hinv, rel_text_mask=rel_mask,
                             question_encoder=qenc)
    model = build_model(cfg, 20, 3, word_dim=WORD_DIM, device="cpu")
    model.load_state_dict(bridge.from_flax(params))
    svc = RetrieverService(cfg, Vocab(ents, rels, {}), model, rel_hidden=rel_h,
                           rel_hidden_inv=rel_hinv, rel_text_mask=rel_mask,
                           question_encoder=qenc)
    q2 = make_question()
    q2["entities"] = ["m.03"]
    questions = [make_question(), q2, {**make_question(), "entities": []}]
    want, got = jsvc.retrieve(questions), svc.retrieve(questions)
    assert len(got) == len(want) == 3 and got[2] == want[2] == {"cand": [], "paths": []}
    for a, b in zip(got, want):
        assert [c for c, _ in a["cand"]] == [c for c, _ in b["cand"]]
        np.testing.assert_allclose([p for _, p in a["cand"]],
                                   [p for _, p in b["cand"]], atol=1e-5)
        assert a["paths"] == b["paths"]
    assert any(res["paths"] for res in got)


def test_unported_options_raise():
    """The options this test once refused are ported: each builds the
    module its option needs (tests/test_torch_rearev_options.py holds them to
    the JAX model); values no package takes still raise."""
    from gnn_rag_tpu_torch.models.nsm import NSM
    for kw, name in ((dict(pos_emb=True), "reasoning.pos_emb_inv1.weight"),
                     (dict(lm="lstm"), "instruction_encoder.lstm.weight_hh_l0"),
                     (dict(lm_frozen=False), "lm.tok_emb.weight"),
                     (dict(normalized_gnn=True), "reasoning.rel_linear0")):
        assert name in ReaRev(ModelConfig(**kw), 10, 3, WORD_DIM).state_dict()
    cfg = Config(model=ModelConfig(model_name="NSM", entity_dim=8))
    assert isinstance(build_model(cfg, 10, 3, word_dim=WORD_DIM, device="cpu"), NSM)
    for kw in (dict(model_name="Foo"), dict(compute_dtype="float16"),
               dict(loss_type="mse")):
        with pytest.raises(NotImplementedError):
            ReaRev(ModelConfig(**kw), 10, 3, WORD_DIM)
