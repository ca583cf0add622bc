"""The gnn_rag_tpu_torch training slice against the JAX package: the
whole-model loss and every parameter gradient, fact dropout with one shared
keep mask, three optimizer steps (global-norm clip, Adam, staircase decay),
the on-device Hit@1 and training F1, the shuffled epoch order, checkpoints
and dropout, with the flax weights carried across by
``gnn_rag_tpu_torch.bridge``.

Tolerances: loss rtol 1e-5; each gradient max|got - ref| <= 1e-4 *
max|ref| + 1e-7 (float32, sums in another order through ~20 layers);
parameters after three Adam steps rtol 1e-4; the step's metric sums 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cli_e2e import write_micro_dataset

from gnn_rag_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from gnn_rag_tpu.data.loader import load_dataset_dir as jax_load_dataset_dir
from gnn_rag_tpu.models import ReaRev as JReaRev
from gnn_rag_tpu.models import base as jbase
from gnn_rag_tpu.models import encoders as jenc
from gnn_rag_tpu.train import metrics as jmetrics
from gnn_rag_tpu.train.trainer import Trainer as JTrainer
from gnn_rag_tpu.utils.synthetic import random_graph_batch, random_rel_hidden
from gnn_rag_tpu_torch import bridge
from gnn_rag_tpu_torch.data.batch import GraphBatch
from gnn_rag_tpu_torch.data.kernel_layout import DirectionLayout, KernelLayout
from gnn_rag_tpu_torch.data.loader import load_dataset_dir
from gnn_rag_tpu_torch.models import base
from gnn_rag_tpu_torch.models import encoders as tenc
from gnn_rag_tpu_torch.models.rearev import ReaRev
from gnn_rag_tpu_torch.train.metrics import train_f1_device
from gnn_rag_tpu_torch.train.trainer import Trainer
from gnn_rag_tpu_torch.utils import checkpoint

WORD_DIM = 32
KEY = jax.random.PRNGKey(0)


def assert_close(got, ref, rel, abs_, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max() + abs_, (name, err, np.abs(ref).max())


def micro_config(root, **model_kw):
    return Config(
        data=DataConfig(name="webqsp", data_folder=str(root) + "/"),
        model=ModelConfig(entity_dim=16, num_iter=2, num_ins=2, num_gnn=2,
                          **{"linear_dropout": 0.0, **model_kw}),
        train=TrainConfig(is_eval=False, batch_size=4, test_batch_size=4,
                          lr=5e-3, decay_rate=0.5, gradient_clip=1e-3,
                          checkpoint_dir=str(root / "ckpt"),
                          experiment_name="micro"))


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """The micro dataset loaded by both packages with shared frozen-LM
    states, and one set of flax weights."""
    root = tmp_path_factory.mktemp("micro_train")
    write_micro_dataset(root)
    cfg = micro_config(root)
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
    params = jax.jit(jmodel.init)(
        KEY, jb["train"].make_batch(range(4), build_layout=True), *rel)
    return dict(root=root, cfg=cfg, jb=jb, tb=tb, rel=rel, nkr=nkr,
                params=params, num_entity=num_entity)


def batches(m, idx, pad_to):
    return (m["jb"]["train"].make_batch(idx, build_layout=True, batch_pad_to=pad_to),
            m["tb"]["train"].make_batch(idx, batch_pad_to=pad_to).to("cpu"))


def port_model(m, cfg_model):
    model = ReaRev(cfg_model, m["num_entity"], m["nkr"], WORD_DIM)
    model.load_state_dict(bridge.from_flax(m["params"]))
    return model


def check_grads(model, jgrads):
    want = bridge.from_flax(jgrads)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        assert_close(got[name].grad.numpy(), g.numpy(), 1e-4, 1e-7, name)


@pytest.mark.parametrize("loss_type", ["kl", "bce"])
def test_whole_model_loss_and_gradients_match_jax(micro, loss_type):
    cfg_model = dataclasses.replace(micro["cfg"].model, loss_type=loss_type)
    jbatch, tbatch = batches(micro, list(range(8)), 10)   # 2 padding rows
    jmodel = JReaRev(cfg=cfg_model, num_entity=micro["num_entity"],
                     num_relation=micro["nkr"])
    want_loss, jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.apply(
        p, jbatch, *micro["rel"], training=True, rngs={"dropout": KEY})[0]))(
        micro["params"])
    model = port_model(micro, cfg_model)
    loss = model(tbatch, *map(torch.from_numpy, micro["rel"]), training=True,
                 generator=torch.Generator().manual_seed(0))[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    check_grads(model, jgrads)


@pytest.mark.parametrize("variant", ["v2", "v3"])
def test_gate_scatter_variants_match_jax(micro, variant, monkeypatch):
    """GNN_RAG_GATE_SCATTER=v2 (rel_linear inside the kernel, one launch per
    direction) and v3 (the port runs v4's op; the JAX model one projected
    launch per direction): loss, pred_dist and every gradient against the
    JAX model under the same variant (set before jax.jit traces it). The
    flax weights of the default variant serve both: no variant adds or drops
    a parameter. In float32 each variant's pred_dist equals v4's
    (rearev.py's default) within 1e-5."""
    monkeypatch.setenv("GNN_RAG_GATE_SCATTER", variant)
    cfg_model = micro["cfg"].model
    jbatch, tbatch = batches(micro, list(range(8)), 10)   # 2 padding rows
    jmodel = JReaRev(cfg=cfg_model, num_entity=micro["num_entity"],
                     num_relation=micro["nkr"])

    def loss_and_dist(p):
        loss, _, dist = jmodel.apply(p, jbatch, *micro["rel"], training=True,
                                     rngs={"dropout": KEY})
        return loss, dist

    (want_loss, want_dist), jgrads = jax.jit(jax.value_and_grad(
        loss_and_dist, has_aux=True))(micro["params"])
    model = port_model(micro, cfg_model)
    rel = tuple(map(torch.from_numpy, micro["rel"]))
    loss, _, dist = model(tbatch, *rel, training=True,
                          generator=torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(dist.detach().numpy(), np.asarray(want_dist),
                               atol=1e-6, rtol=1e-4)
    check_grads(model, jgrads)
    with torch.no_grad():
        dists = {}
        for v in (variant, "v4"):
            monkeypatch.setenv("GNN_RAG_GATE_SCATTER", v)
            dists[v] = model(tbatch, *rel)[2]
    assert_close(dists[variant].numpy(), dists["v4"].numpy(), 0.0, 1e-5)


def test_fact_dropout_gradients_match_jax(micro, monkeypatch):
    """fact_drop 0.3: both packages drop the same facts (the JAX model's
    Bernoulli draw is replaced by the mask the port is given); self loops are
    kept; loss and every gradient agree."""
    cfg_model = dataclasses.replace(micro["cfg"].model, fact_drop=0.3)
    jbatch, tbatch = batches(micro, list(range(8)), 8)
    keep = np.random.default_rng(9).random(jbatch.fact_mask.shape) > 0.3
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep))
    jmodel = JReaRev(cfg=cfg_model, num_entity=micro["num_entity"],
                     num_relation=micro["nkr"])
    want_loss, jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.apply(
        p, jbatch, *micro["rel"], training=True, rngs={"dropout": KEY})[0]))(
        micro["params"])
    drop_keep = torch.where(tbatch.rels == micro["nkr"] - 1, 1.0,
                            torch.from_numpy(keep.astype(np.float32)))
    model = port_model(micro, cfg_model)
    loss = model(tbatch, *map(torch.from_numpy, micro["rel"]), training=True,
                 generator=torch.Generator().manual_seed(0), drop_keep=drop_keep)[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    check_grads(model, jgrads)
    # the drop changed the model's output
    with torch.no_grad():
        assert float(loss) != float(model(tbatch, *map(torch.from_numpy,
                                                        micro["rel"]))[0])


def port_batch(jb) -> GraphBatch:
    names = [f.name for f in dataclasses.fields(GraphBatch) if f.name != "layout"]
    kl = jb.layout
    return GraphBatch(**{n: getattr(jb, n) for n in names}, layout=KernelLayout(
        DirectionLayout(*kl.fwd), DirectionLayout(*kl.inv), kl.num_entities))


def test_type_layer_drop_keep_matches_jax():
    """TypeLayer given the same explicit fact-dropout keep mask."""
    rng = np.random.default_rng(3)
    D, R = 16, 9
    jb = random_graph_batch(rng, batch_size=2, n_entities=256, n_facts=600,
                            num_relation=R, word_dim=None, build_layout=True)
    rel = rng.standard_normal((R + 1, D)).astype(np.float32)
    keep = (rng.random(jb.fact_mask.shape) > 0.3).astype(np.float32)
    m = jenc.TypeLayer(D)
    args = (rel, jb.heads, jb.rels, jb.tails, jb.fact_mask, 256,
            jb.fact_rel_weight)
    p = m.init(KEY, *args, layout=jb.layout)
    want = m.apply(p, *args, layout=jb.layout, drop_keep=jnp.asarray(keep))
    mod = tenc.TypeLayer(D, D)
    mod.load_state_dict(bridge.from_flax(p))
    got = mod(torch.from_numpy(rel), port_batch(jb).to("cpu").layout, 256,
              torch.from_numpy(keep))
    assert_close(got.detach().numpy(), want, 1e-5, 1e-6)
    assert not np.allclose(want, m.apply(p, *args, layout=jb.layout))


def test_trainer_steps_match_jax(micro, tmp_path):
    """Three steps from the same weights on the same batches (one with a
    padding row): clip 1e-3 bites, the staircase decay (0.5 every 2 steps)
    halves the third step's rate; parameters and the metric sums agree."""
    cfg = dataclasses.replace(micro["cfg"], train=dataclasses.replace(
        micro["cfg"].train, checkpoint_dir=str(tmp_path)))
    kw = dict(valid_data=None, test_data=None, num_entity=micro["num_entity"],
              num_kb_relation=micro["nkr"], rel_hidden=micro["rel"][0],
              rel_hidden_inv=micro["rel"][1], rel_text_mask=micro["rel"][2])
    jtr = JTrainer(cfg, train_data=micro["jb"]["train"], **kw)
    tr = Trainer(cfg, train_data=micro["tb"]["train"], word_dim=WORD_DIM,
                 device="cpu", **kw)
    assert jtr.tx is not None and tr.steps_per_epoch == 2
    tr.model.load_state_dict(bridge.from_flax(micro["params"]))
    params, opt_state = micro["params"], jtr.tx.init(micro["params"])
    jstep = jax.jit(jtr._train_step_impl)
    zero = jnp.zeros((), jnp.float32)
    jacc, acc = (zero,) * 4, torch.zeros(4)
    for idx in ([0, 1, 2, 3], [4, 5, 6], [7, 0, 1, 2]):
        jbatch, tbatch = batches(micro, idx, 4)
        valid_w = np.zeros(4, np.float32)
        valid_w[:len(idx)] = 1.0
        params, opt_state, jacc = jstep(params, opt_state, KEY, jbatch,
                                        jnp.asarray(valid_w), jacc)
        acc = tr.train_step(tbatch, torch.from_numpy(valid_w), acc)
    assert tr.step_count == 3 and tr.learning_rate(2) == cfg.train.lr * 0.5
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-5,
                               atol=1e-6)
    want = bridge.from_flax(params)
    got = tr.model.state_dict()
    moved = 0
    for name, w in want.items():
        if name == "reasoning.score_func.bias":
            # its gradient is 0 up to rounding (the softmax is shift
            # invariant), so Adam's normalised step follows the sign of
            # rounding noise: only bounded by 3 steps of the rate
            assert np.abs(got[name].numpy()).max() <= 3 * cfg.train.lr
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        moved += not np.allclose(w.numpy(), bridge.from_flax(
            micro["params"])[name].numpy())
    assert moved == len(want) - 1
    tr.close()


def test_calc_h1_and_train_f1_match_jax():
    """Random distributions with ties, pad slots, seeds and empty answers."""
    rng = np.random.default_rng(4)
    B, E, pad = 12, 64, 1000
    pred = rng.integers(0, 6, (B, E)).astype(np.float32)   # many ties
    pred[3] = 1.0                                           # all tied
    pred[5, :] = 0.0
    pred[5, 7] = 1.0
    pred = pred / pred.sum(1, keepdims=True)
    answers = (rng.random((B, E)) > 0.85).astype(np.float32)
    answers[[1, 6]] = 0.0                                   # no answer
    gids = rng.integers(0, 900, (B, E)).astype(np.int32)
    gids[:, 50:] = pad
    seed = np.zeros((B, E), np.float32)
    seed[np.arange(B), rng.integers(0, 50, B)] = 1.0
    answers[0, :] = 0.0
    answers[0, np.argmax(pred[0])] = 1.0                    # a hit
    t = torch.from_numpy
    h1 = base.calc_h1(t(pred), t(answers))
    want_h1 = jbase.calc_h1(jnp.asarray(pred), jnp.asarray(answers))
    np.testing.assert_array_equal(h1.numpy(), np.asarray(want_h1))
    assert h1.sum() > 0
    for h in (h1, torch.ones(B)):       # also the F1 of every row
        f1 = train_f1_device(t(pred), t(answers), h, t(gids), t(seed), pad, 0.95)
        want = jmetrics.train_f1_device(
            jnp.asarray(pred), jnp.asarray(answers), jnp.asarray(h.numpy()),
            jnp.asarray(gids), jnp.asarray(seed), pad, 0.95)
        np.testing.assert_allclose(f1.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    assert 0 < f1.sum() < B


@pytest.mark.parametrize("bucket_size", [None, 3])
def test_shuffled_order_matches_jax_loader(micro, bucket_size):
    jds, tds = micro["jb"]["train"], micro["tb"]["train"]
    assert tds.num_data == jds.num_data == 8
    np.testing.assert_array_equal(tds.batch_indices(1, 3), [3, 4, 5])
    for ds in (jds, tds):
        ds.reset_batches(is_sequential=False, rng=np.random.default_rng(11),
                         bucket_size=bucket_size)
    for it in range(3):
        np.testing.assert_array_equal(tds.batch_indices(it, 3),
                                      jds.batch_indices(it, 3))
    assert sorted(np.concatenate([tds.batch_indices(i, 3) for i in range(3)])) \
        == list(range(8))
    tds.reset_batches()
    jds.reset_batches()
    np.testing.assert_array_equal(tds.batch_indices(0, 8), np.arange(8))


def test_checkpoint_roundtrip_and_partial_load(tmp_path):
    full = {"a": torch.ones(2, 2), "b": torch.zeros(3),
            "new_layer": torch.full((4,), 7.0)}
    old = {"a": torch.full((2, 2), 5.0), "b": torch.full((5,), 9.0),
           "gone": torch.ones(1)}
    path = str(tmp_path / "sub" / "old.ckpt")
    checkpoint.save_state(path, old)
    raw = checkpoint.load_state(path)
    assert set(raw) == set(old) and all(torch.equal(raw[k], old[k]) for k in old)
    merged = checkpoint.load_state(path, full, partial=True)
    assert set(merged) == set(full)
    assert torch.equal(merged["a"], old["a"])          # name and shape match
    assert torch.equal(merged["b"], full["b"])         # shape differs: kept
    assert torch.equal(merged["new_layer"], full["new_layer"])
    with pytest.raises(ValueError, match="b: checkpoint \\(5,\\) vs model"):
        checkpoint.load_state(path, full, partial=False)


def test_trainer_checkpoint_roundtrip(micro, tmp_path):
    cfg = dataclasses.replace(micro["cfg"], train=dataclasses.replace(
        micro["cfg"].train, checkpoint_dir=str(tmp_path)))
    tr = Trainer(cfg, train_data=micro["tb"]["train"],
                 valid_data=micro["tb"]["valid"], test_data=micro["tb"]["test"],
                 num_entity=micro["num_entity"], num_kb_relation=micro["nkr"],
                 rel_hidden=micro["rel"][0], rel_hidden_inv=micro["rel"][1],
                 rel_text_mask=micro["rel"][2], word_dim=WORD_DIM,
                 device="cpu")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.save_ckpt("h1")
    loss, h1, f1 = tr.train_epoch()
    assert np.isfinite(loss) and 0 <= h1 <= 1 and 0 <= f1 <= 1
    assert tr.step_count == 2
    assert not torch.equal(tr.model.state_dict()["question_emb.weight"],
                           before["question_emb.weight"])
    tr.load_ckpt(tr._ckpt_path("h1"))
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert (tmp_path / "micro-h1.ckpt.meta.json").exists()
    tr.close()


def test_dropout_identity_at_eval_and_scaled_keep_in_training(micro):
    x = torch.ones(200_000)
    assert tenc.dropout(x, 0.2, None) is x                     # eval
    a = tenc.dropout(x, 0.2, torch.Generator().manual_seed(1))
    b = tenc.dropout(x, 0.2, torch.Generator().manual_seed(1))
    c = tenc.dropout(x, 0.2, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)         # reproducible
    assert set(a.unique().tolist()) == {0.0, 1.0 / 0.8}
    assert abs((a > 0).float().mean().item() - 0.8) < 0.005    # keeps 1 - p
    # the whole model: training mode draws masks, eval mode is deterministic
    cfg_model = dataclasses.replace(micro["cfg"].model, linear_dropout=0.2,
                                    fact_drop=0.1)
    _, tbatch = batches(micro, list(range(4)), 4)
    model = port_model(micro, cfg_model)
    rel = tuple(map(torch.from_numpy, micro["rel"]))
    with torch.no_grad():
        ev = model(tbatch, *rel)[0]
        assert torch.equal(ev, model(tbatch, *rel, training=False,
                                     generator=torch.Generator())[0])
        tr1 = model(tbatch, *rel, training=True,
                    generator=torch.Generator().manual_seed(5))[0]
        tr2 = model(tbatch, *rel, training=True,
                    generator=torch.Generator().manual_seed(5))[0]
    assert torch.equal(tr1, tr2) and not torch.equal(tr1, ev)
    with pytest.raises(ValueError, match="generator"):
        model(tbatch, *rel, training=True)
