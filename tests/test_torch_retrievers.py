"""NSM and GraftNet in gnn_rag_tpu_torch against the JAX package, and the
modules they add: the LSTM question encoder, TypeLayer's ``norm_rel`` on the
kernel layout and on the COO facts, ``js_div_vec`` / ``masked_mean_loss``,
``head_degree_weight``, ``scatter_facts_to_entities``; the whole models'
loss, answer distribution and every parameter gradient on the layout path
and on the COO path (``layout`` None on both sides: the JAX Trainer builds
layouts only on the TPU, so each path is held to JAX's own); three Adam
steps of each through the port's Trainer; ``python -m gnn_rag_tpu_torch
NSM|GraftNet --device cpu``, its `.info` held to the JAX CLI's; the loader's
process pool and ingest cache. Flax weights cross by
``gnn_rag_tpu_torch.bridge``.

Tolerances (those of tests/test_torch_train.py): loss rtol 1e-5; each
gradient max|got - ref| <= 1e-4 * max|ref| + 1e-7; parameters after three
Adam steps rtol 1e-4 / atol 1e-6; distributions atol 1e-6 (rtol 1e-4 where
the JAX layout-vs-COO check uses it).
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cli_e2e import write_micro_dataset

from gnn_rag_tpu import cli as jcli
from gnn_rag_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from gnn_rag_tpu.data import loader as jloader
from gnn_rag_tpu.data.kernel_layout import build_kernel_layout
from gnn_rag_tpu.models import base as jbase
from gnn_rag_tpu.models import encoders as jenc
from gnn_rag_tpu.models.graftnet import GraftNet as JGraftNet
from gnn_rag_tpu.models.nsm import NSM as JNSM
from gnn_rag_tpu.ops import degree as jdegree
from gnn_rag_tpu.ops import segment as jseg
from gnn_rag_tpu.train.trainer import Trainer as JTrainer
from gnn_rag_tpu.utils.synthetic import random_graph_batch, random_rel_hidden
from gnn_rag_tpu_torch import bridge
from gnn_rag_tpu_torch.data import loader
from gnn_rag_tpu_torch.data.batch import GraphBatch
from gnn_rag_tpu_torch.data.kernel_layout import DirectionLayout, KernelLayout
from gnn_rag_tpu_torch.data.vocab import Vocab
from gnn_rag_tpu_torch.models import base
from gnn_rag_tpu_torch.models import encoders as tenc
from gnn_rag_tpu_torch.models.graftnet import GraftNet
from gnn_rag_tpu_torch.models.nsm import NSM
from gnn_rag_tpu_torch.ops import degree, segment
from gnn_rag_tpu_torch.train.trainer import Trainer
from gnn_rag_tpu_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)
NUM_REL = 12          # num_kb_relation (self loop last)
NUM_ENT = 1000
WORD_DIM = 32
t = torch.from_numpy


def assert_close(got, ref, rel, abs_, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max() + abs_, (name, err, np.abs(ref).max())


def to_port(jb) -> GraphBatch:
    """The JAX batch's arrays as the port's GraphBatch of CPU tensors."""
    names = [f.name for f in dataclasses.fields(GraphBatch) if f.name != "layout"]
    kl = jb.layout
    layout = None if kl is None else KernelLayout(
        DirectionLayout(*kl.fwd), DirectionLayout(*kl.inv), kl.num_entities)
    return GraphBatch(**{n: np.asarray(getattr(jb, n)) for n in names},
                      layout=layout).to("cpu")


def synthetic_batch(seed=11, B=3, E=128, F=512):
    """A random batch whose last row is batch padding (no facts), facts
    weighted by 1/count(head, rel) (the loader's rel_pair_weight), with the
    kernel layout over those weights."""
    rng = np.random.default_rng(seed)
    jb = random_graph_batch(rng, batch_size=B, n_entities=E, n_facts=F,
                            num_relation=NUM_REL, num_entity_global=NUM_ENT,
                            word_dim=WORD_DIM)
    heads, rels, tails = (np.array(x) for x in (jb.heads, jb.rels, jb.tails))
    mask = np.array(jb.fact_mask)
    gids, seed_d, qe, ans = (np.array(x) for x in (
        jb.entity_gids, jb.seed_dist, jb.query_entities, jb.answer_dist))
    heads[-1], tails[-1], rels[-1], mask[-1] = 0, 0, NUM_REL, 0.0
    gids[-1], seed_d[-1], qe[-1], ans[-1] = NUM_ENT, 0.0, 0.0, 0.0
    w = np.zeros_like(mask)
    for b in range(B):
        keys = heads[b] * (NUM_REL + 1) + rels[b]
        _, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
        w[b] = mask[b] / counts[inv]
    jb = jb.replace(heads=heads, rels=rels, tails=tails, fact_mask=mask,
                    entity_gids=gids, seed_dist=seed_d, query_entities=qe,
                    answer_dist=ans, fact_rel_weight=w,
                    layout=build_kernel_layout(heads, rels, tails, mask, E,
                                               pad_rel=NUM_REL, fact_weight=w))
    rel = random_rel_hidden(rng, NUM_REL + 1, 4, WORD_DIM)
    return jb, rel


@pytest.fixture(scope="module")
def batch():
    return synthetic_batch()


# ------------------------------------------------------------------ modules
def test_losses_degree_and_scatter_match_jax():
    rng = np.random.default_rng(2)
    d1 = rng.random((4, 30)).astype(np.float32)
    d1[:, ::3] = 0.0
    d1 /= d1.sum(1, keepdims=True)
    d2 = rng.random((4, 30)).astype(np.float32)
    d2[:, 1::4] = 0.0
    d2 /= d2.sum(1, keepdims=True)
    assert_close(base.js_div_vec(t(d1), t(d2)).numpy(),
                 jbase.js_div_vec(jnp.asarray(d1), jnp.asarray(d2)), 1e-6, 1e-8)
    valid = np.array([[1.0], [0.0], [1.0], [1.0]], np.float32)
    np.testing.assert_allclose(
        base.masked_mean_loss(t(d1), t(valid)).item(),
        float(jbase.masked_mean_loss(jnp.asarray(d1), jnp.asarray(valid))),
        rtol=1e-6)
    heads = rng.integers(0, 20, (3, 64)).astype(np.int32)
    mask = (rng.random((3, 64)) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        degree.head_degree_weight(t(heads), t(mask), 128).numpy(),
        np.asarray(jdegree.head_degree_weight(jnp.asarray(heads),
                                              jnp.asarray(mask), 128)),
        rtol=1e-6)
    vals = rng.standard_normal((3, 64, 5)).astype(np.float32)
    for v, m in ((vals, mask), (vals[..., 0], None)):
        assert_close(
            segment.scatter_facts_to_entities(
                t(v), t(heads), 128, None if m is None else t(m)).numpy(),
            jseg.scatter_facts_to_entities(jnp.asarray(v), jnp.asarray(heads), 128,
                                           None if m is None else jnp.asarray(m)),
            1e-6, 1e-7)


@pytest.mark.parametrize("pretrained", [False, True])
def test_lstm_encoder_matches_jax(pretrained):
    """Hidden states and the last position's state (pads included), the
    gradient of every weight, with and without a frozen word table (ids past
    its rows clamp to the last)."""
    rng = np.random.default_rng(5)
    tok = rng.integers(0, 31, (3, 9)).astype(np.int32)
    tok[:, 6:] = 30                                   # pad id = num_word
    table = rng.standard_normal((25, 12)).astype(np.float32) if pretrained else None
    m = jenc.LSTMQuestionEncoder(16, 30, 12)
    p = m.init(KEY, jnp.asarray(tok),
               pretrained=None if table is None else jnp.asarray(table))

    def f(params):
        h, n = m.apply(params, jnp.asarray(tok),
                       pretrained=None if table is None else jnp.asarray(table))
        return jnp.sum(h * h) + jnp.sum(jnp.sin(n)), (h, n)

    (_, (h, n)), g = jax.value_and_grad(f, has_aux=True)(p)
    mod = tenc.LSTMQuestionEncoder(16, 30, 12, pretrained_dim=None if table is None
                                   else table.shape[1])
    mod.load_state_dict(bridge.from_flax(p))
    th, tn = mod(t(tok), None, None if table is None else t(table))
    ((th * th).sum() + torch.sin(tn).sum()).backward()
    assert_close(th.detach().numpy(), h, 1e-5, 1e-7)
    assert_close(tn.detach().numpy(), n, 1e-5, 1e-7)
    np.testing.assert_array_equal(tn.detach().numpy(), th[:, -1].detach().numpy())
    want = bridge.from_flax(g)
    for name, par in mod.named_parameters():
        assert_close(par.grad.numpy(), want[name].numpy(), 1e-4, 1e-7, name)
    assert set(want) == {n for n, _ in mod.named_parameters()}
    assert "lstm.bias_ih_l0" not in mod.state_dict()
    assert not mod.lstm.bias_ih_l0.any()


@pytest.mark.parametrize("path", ["layout", "coo"])
def test_type_layer_norm_rel_matches_jax(batch, path):
    """norm_rel: the layout's per-fact weight as the prior, or
    fact_mask * rel_pair_weight over the COO facts; the weight changes the
    output."""
    jb, _ = batch
    if path == "coo":
        jb = jb.replace(layout=None)
    rng = np.random.default_rng(3)
    rel = rng.standard_normal((NUM_REL + 1, 16)).astype(np.float32)
    args = (rel, jb.heads, jb.rels, jb.tails, jb.fact_mask, 128, jb.fact_rel_weight)
    m = jenc.TypeLayer(16, True)
    p = m.init(KEY, *args, layout=jb.layout)
    want = m.apply(p, *args, layout=jb.layout)
    mod = tenc.TypeLayer(16, 16, norm_rel=True)
    mod.load_state_dict(bridge.from_flax(p))
    pb = to_port(jb)
    got = mod(t(rel), pb.layout, 128, batch=pb)
    assert_close(got.detach().numpy(), want, 1e-5, 1e-6)
    plain = jenc.TypeLayer(16, False).apply(p, *args, layout=jb.layout)
    assert not np.allclose(want, plain)


# -------------------------------------------------------------- whole models
def jax_loss_grads(model, params, jb, rel):
    def f(p):
        loss, _, dist = model.apply(p, jb, *rel, training=True,
                                    rngs={"dropout": KEY})
        return loss, dist
    (loss, dist), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return float(loss), np.asarray(dist), g


def check_model(model, params, jb, rel, port_cls, cfg):
    want_loss, want_dist, jgrads = jax_loss_grads(model, params, jb, rel)
    mod = port_cls(cfg, NUM_ENT, NUM_REL, WORD_DIM)
    mod.load_state_dict(bridge.from_flax(params))
    loss, _, dist = mod(to_port(jb), *map(t, rel), training=True,
                        generator=torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    np.testing.assert_allclose(dist.detach().numpy(), want_dist, atol=1e-6,
                               rtol=1e-4)
    want = bridge.from_flax(jgrads)
    got = dict(mod.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        # a parameter the loss does not reach (the teacher's last step) has
        # no torch gradient and a zero JAX one
        gt = got[name].grad
        gt = torch.zeros_like(got[name]) if gt is None else gt
        assert np.isfinite(gt.numpy()).all(), name
        assert_close(gt.numpy(), g.numpy(), 1e-4, 1e-7, name)
    return mod


@pytest.mark.parametrize("path", ["layout", "coo"])
@pytest.mark.parametrize("kw", [
    dict(num_step=3),
    dict(num_step=2, reason_kb=True),
    dict(num_step=2, lambda_back=0.1, lambda_constrain=0.1),
], ids=["plain", "reason_kb", "teacher"])
def test_nsm_matches_jax(batch, kw, path):
    jb, rel = batch
    if path == "coo":
        jb = jb.replace(layout=None)
    cfg = ModelConfig(model_name="NSM", entity_dim=16, linear_dropout=0.0, **kw)
    model = JNSM(cfg=cfg, num_entity=NUM_ENT, num_relation=NUM_REL)
    params = model.init(KEY, jb, *rel)
    mod = check_model(model, params, jb, rel, NSM, cfg)
    assert hasattr(mod, "reasoning_back") == ("lambda_back" in kw)


@pytest.mark.parametrize("path", ["layout", "coo"])
@pytest.mark.parametrize("loss_type", ["bce", "kl"])
def test_graftnet_matches_jax(batch, loss_type, path):
    """The padding row (no facts) keeps every gradient finite."""
    jb, rel = batch
    if path == "coo":
        jb = jb.replace(layout=None)
    cfg = ModelConfig(model_name="GraftNet", entity_dim=16, num_layer=2,
                      loss_type=loss_type, linear_dropout=0.0)
    model = JGraftNet(cfg=cfg, num_entity=NUM_ENT, num_relation=NUM_REL)
    params = model.init(KEY, jb, *rel)
    check_model(model, params, jb, rel, GraftNet, cfg)


def test_fact_dropout_keep_masks_match_jax(batch, monkeypatch):
    """fact_drop 0.3 with one shared draw: NSM keeps self loops, GraftNet
    drops them too; loss and distribution agree, and the drop moved them."""
    jb, rel = batch
    keep = np.random.default_rng(9).random(jb.fact_mask.shape) > 0.3
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep))
    pb = to_port(jb)
    self_loop = pb.rels == NUM_REL - 1
    for cls, jcls, kw, keep_loops in (
            (NSM, JNSM, dict(model_name="NSM", num_step=2), True),
            (GraftNet, JGraftNet, dict(model_name="GraftNet", num_layer=2), False)):
        cfg = ModelConfig(entity_dim=16, linear_dropout=0.0, fact_drop=0.3, **kw)
        model = jcls(cfg=cfg, num_entity=NUM_ENT, num_relation=NUM_REL)
        params = model.init(KEY, jb, *rel)
        want_loss, want_dist, _ = jax_loss_grads(model, params, jb, rel)
        mod = cls(cfg, NUM_ENT, NUM_REL, WORD_DIM)
        mod.load_state_dict(bridge.from_flax(params))
        drop_keep = torch.from_numpy(keep.astype(np.float32))
        if keep_loops:
            drop_keep = torch.where(self_loop, 1.0, drop_keep)
        with torch.no_grad():
            loss, _, dist = mod(pb, *map(t, rel), training=True,
                                generator=torch.Generator(), drop_keep=drop_keep)
            undropped = mod(pb, *map(t, rel))[0]
        np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
        np.testing.assert_allclose(dist.numpy(), want_dist, atol=1e-6, rtol=1e-4)
        assert loss.item() != undropped.item()


# ------------------------------------------------------------ Trainer steps
def write_rich_dataset(root, n=12, n_ent=16, n_tuples=24, seed=0):
    """The micro dataset's files with denser subgraphs (several facts
    share a head and relation)."""
    write_micro_dataset(root)
    ents = (root / "entities.txt").read_text().split()
    ents += [f"m.x{i}" for i in range(n_ent - len(ents))]
    (root / "entities.txt").write_text("\n".join(ents) + "\n")
    rels = (root / "relations.txt").read_text().split()
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(n):
        seed_e, answer = ents[i % len(ents)], ents[(i + 5) % len(ents)]
        tuples = [[seed_e, rels[i % 3], answer]]
        for _ in range(n_tuples):
            h, tl = rng.choice(ents, 2, replace=False)
            tuples.append([str(h), rels[int(rng.integers(3))], str(tl)])
        nodes = sorted({x for tp in tuples for x in (tp[0], tp[2])})
        qs.append({"id": f"q{i}", "question": f"what film is born in {i}",
                   "entities": [seed_e],
                   "subgraph": {"entities": nodes, "tuples": tuples},
                   "answers": [{"kb_id": answer, "text": f"name{i}"}]})
    for split, sl in (("train", slice(0, 8)), ("dev", slice(8, 10)),
                      ("test", slice(10, 12))):
        with open(root / f"{split}.json", "w") as f:
            for q in qs[sl]:
                f.write(json.dumps(q) + "\n")


@pytest.mark.parametrize("name,kw", [
    ("NSM", dict(num_step=2, lambda_back=0.1, lambda_constrain=0.1)),
    ("GraftNet", dict(num_layer=2, loss_type="bce")),
])
def test_trainer_steps_match_jax(tmp_path, name, kw):
    """Three steps on the same layout batches (one with a padding row),
    each step of the port's Trainer from the JAX trainer's parameters of
    that step (its Adam moments its own): clip 1e-3 bites, the staircase
    decay halves the third step's rate; parameters after each step and the
    metric sums agree. (Run freely, the two drift apart: units that reach
    only masked entities have rounding-level gradients, whose eps-limited
    Adam steps differ by ~1e-5 and move every later gradient.) Adam divides
    by the gradient's RMS, so a gradient that is zero up to rounding moves
    its parameter by up to lr in the rounding's direction: the biases that
    feed only a softmax, and each element whose gradient at the step is
    within 1e-4 of its parameter's largest (a unit that reaches only masked
    entities), are held to one step of the rate from where the step
    started."""
    write_rich_dataset(tmp_path)
    cfg = Config(
        data=DataConfig(name="webqsp", data_folder=str(tmp_path) + "/"),
        model=ModelConfig(model_name=name, entity_dim=16, linear_dropout=0.0,
                          **kw),
        train=TrainConfig(is_eval=False, batch_size=4, test_batch_size=4,
                          lr=5e-3, decay_rate=0.5, gradient_clip=1e-3,
                          checkpoint_dir=str(tmp_path / "ckpt")))
    jb, tb = jloader.load_dataset_dir(cfg), loader.load_dataset_dir(cfg)
    nkr = tb["num_kb_relation"]
    rng = np.random.default_rng(0)
    rel = random_rel_hidden(rng, nkr + 1, 4, WORD_DIM)
    hid = [rng.standard_normal((len(r.q_token_ids), WORD_DIM)).astype(np.float32)
           for r in tb["train"].records]
    jb["train"].q_hidden = tb["train"].q_hidden = hid
    num_entity = tb["vocab"].num_entity
    common = dict(valid_data=None, test_data=None, num_entity=num_entity,
                  num_kb_relation=nkr, rel_hidden=rel[0], rel_hidden_inv=rel[1],
                  rel_text_mask=rel[2])
    jtr = JTrainer(cfg, train_data=jb["train"], **common)
    tr = Trainer(cfg, train_data=tb["train"], device="cpu", **common)
    assert tr.evaluator.num_iter == kw.get("num_step", kw.get("num_layer"))
    params = jtr.params
    tr.model.load_state_dict(bridge.from_flax(params))
    opt_state = jtr.tx.init(params)
    jstep = jax.jit(jtr._train_step_impl)
    zero = jnp.zeros((), jnp.float32)
    jacc, acc = (zero,) * 4, torch.zeros(4)
    softmax_biases = {"instruction_decoder.ca_linear.bias",
                      "reasoning_back.score_func.bias"}
    if kw.get("loss_type") != "bce":
        softmax_biases.add("reasoning.score_func.bias")
    first = bridge.from_flax(params)
    for idx in ([0, 1, 2, 3], [4, 5, 6], [7, 0, 1, 2]):
        jbatch = jb["train"].make_batch(idx, build_layout=True, batch_pad_to=4)
        tbatch = tb["train"].make_batch(idx, batch_pad_to=4).to("cpu")
        valid_w = np.zeros(4, np.float32)
        valid_w[:len(idx)] = 1.0
        start = bridge.from_flax(params)
        tr.model.load_state_dict(start)
        params, opt_state, jacc = jstep(params, opt_state, KEY, jbatch,
                                        jnp.asarray(valid_w), jacc)
        acc = tr.train_step(tbatch, t(valid_w), acc)
        noisy = {}
        for n, par in tr.model.named_parameters():
            g = (torch.zeros_like(par) if par.grad is None else par.grad).abs()
            noisy[n] = (g <= 1e-4 * g.max()).numpy()
        check_params(tr.model.state_dict(), bridge.from_flax(params), start,
                     noisy, softmax_biases, cfg.train.lr)
    moved = sum(not np.allclose(w.numpy(), first[n].numpy())
                for n, w in bridge.from_flax(params).items())
    assert moved > len(first) // 2
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-5,
                               atol=1e-6)
    tr.close()


def check_params(got, want, start, noisy, softmax_biases, lr):
    assert set(want) == set(got)
    for n, w in want.items():
        g, w, s0 = got[n].numpy(), w.numpy(), start[n].numpy()
        if n in softmax_biases:
            assert np.abs(g - s0).max() <= lr, n
            continue
        assert (np.abs(g - s0)[noisy[n]] <= lr).all(), n
        np.testing.assert_allclose(g[~noisy[n]], w[~noisy[n]], rtol=1e-4,
                                   atol=1e-6, err_msg=n)


# --------------------------------------------------------------------- CLI
def cli_flags(name, data, ckpt):
    model = (["NSM", "--num_step", "2", "--lambda_back", "0.1",
              "--lambda_constrain", "0.1"] if name == "NSM"
             else ["GraftNet", "--num_layer", "2", "--loss_type", "bce"])
    return model + ["--lm", "lstm", "--relation_word_emb", "False",
                    "--entity_dim", "16", "--word_dim", "12",
                    "--batch_size", "4", "--test_batch_size", "4",
                    "--data_folder", str(data) + "/", "--checkpoint_dir",
                    str(ckpt), "--experiment_name", "x"]


@pytest.mark.parametrize("name", ["NSM", "GraftNet"])
def test_cli_info_matches_jax_cli(tmp_path, name):
    """``python -m gnn_rag_tpu_torch <model> --device cpu``: --lm lstm with
    a frozen word table (word_emb.npy) and trainable relation tables. One
    training epoch writes the checkpoints; then the JAX CLI's model (its
    seeded init, carried across by the bridge) evaluated by both CLIs writes
    the same `.info` (the JAX CLI runs the COO path on the CPU, the port the
    layout path)."""
    data = tmp_path / "data"
    data.mkdir()
    write_micro_dataset(data)
    n_words = len((data / "vocab.txt").read_text().split())
    np.save(data / "word_emb.npy", np.random.default_rng(1).standard_normal(
        (n_words, 12)).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=REPO)
    port = cli_flags(name, data, tmp_path / "port")
    proc = subprocess.run(
        [sys.executable, "-m", "gnn_rag_tpu_torch", *port, "--device", "cpu",
         "--num_epoch", "1", "--eval_every", "1", "--lr", "0.003"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Epoch: 1" in proc.stdout + proc.stderr
    assert (tmp_path / "port" / "x-final.ckpt").exists()

    jargs = cli_flags(name, data, tmp_path / "jax") + ["--is_eval"]
    ctx = jcli.assemble(jargs)
    ctx["trainer"].evaluate_single()
    checkpoint.save_state(str(tmp_path / "port" / "jax.ckpt"),
                          bridge.from_flax(ctx["trainer"].params))
    proc = subprocess.run(
        [sys.executable, "-m", "gnn_rag_tpu_torch", *port, "--device", "cpu",
         "--is_eval", "--load_experiment", "jax.ckpt"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = [json.loads(x) for x in open(tmp_path / "jax" / "x_test.info")]
    got = [json.loads(x) for x in open(tmp_path / "port" / "x_test.info")]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert list(a) == list(b)
        assert [c for c, _ in a["cand"]] == [c for c, _ in b["cand"]]
        np.testing.assert_allclose([p for _, p in a["cand"]],
                                   [p for _, p in b["cand"]], atol=1e-6)
        assert {k: v for k, v in a.items() if k != "cand"} == {
            k: v for k, v in b.items() if k != "cand"}


# ------------------------------------------------------------------ loader
def test_load_split_pool_and_cache_match_jax(tmp_path):
    """num_workers 2 and the pickle cache give the JAX package's records;
    the port's cache file is its own; a changed split is ingested again."""
    write_rich_dataset(tmp_path)
    vocab = Vocab.from_dir(str(tmp_path) + "/", "entities.txt",
                           "relations.txt", "vocab.txt")
    from gnn_rag_tpu.data.vocab import Vocab as JVocab
    jvocab = JVocab.from_dir(str(tmp_path) + "/", "entities.txt",
                             "relations.txt", "vocab.txt")
    path = str(tmp_path / "train.json")
    kw = dict(data_name="webqsp", use_inverse_relation=True, use_self_loop=True)
    want = jloader.load_split(path, jvocab, cache=False, **kw)

    def same(recs):
        assert len(recs) == len(want) == 8
        for a, b in zip(recs, want):
            for f in ("heads", "rels", "tails", "rel_pair_weight", "entity_gids",
                      "seed_locals", "answer_locals", "droppable"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
            assert a.answer_gids == b.answer_gids and a.qid == b.qid

    pooled = loader.load_split(path, vocab, num_workers=2, **kw)
    same(pooled)
    cpath = path + ".ingest.torch.pkl"
    assert os.path.exists(cpath) and not os.path.exists(path + ".ingest.pkl")
    with open(cpath, "rb") as f:
        saved = pickle.load(f)
    saved["records"][0].question = "from the cache"
    with open(cpath, "wb") as f:
        pickle.dump(saved, f)
    cached = loader.load_split(path, vocab, **kw)
    assert cached[0].question == "from the cache"          # a cache hit
    same(cached)
    same(loader.load_split(path, vocab, max_questions=None, cache=False, **kw))
    # another option, then a changed file: both ingest again
    assert loader.load_split(path, vocab, max_questions=3, **kw)[0].question \
        != "from the cache"
    lines = open(path).read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join(lines[:5]) + "\n")
    assert len(loader.load_split(path, vocab, **kw)) == 5
