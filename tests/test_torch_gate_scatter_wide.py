"""The gate-scatter kernels' column windows, on the CPU.

On the card each gate-scatter kernel takes a window of D's columns for all
J instructions where a block cannot hold the whole ``[128, J*D]`` tile
(``ops.gate_scatter.window_plan``, fed by the library's fit entry). Here:

- the window plan: every column once, every window but the last a whole
  number of 16-byte copies, none wider than the fit, one window where the
  width fits (today's shapes);
- the decomposition the kernels compute, on the plain versions: each
  window's columns from the window's slices of the inputs, the windows'
  partial sums over all columns (dprior, the fused backward's dfact_rel)
  added in window order, against the whole-width plain version. The
  forward, dvals, dins, dw and db exact; dprior and dfact_rel within
  1e-6 of their largest entry (float32 sums in another order);
- the port at the widths the kernels took only in windows, against the JAX
  package (whose gate-scatter runs its XLA reference on the CPU): a ReaRev
  train step at CWQ's three instructions and entity dim 128 under v4 and
  v2 (loss, every gradient, one Adam step through both Trainers), NSM and
  TypeLayer at entity dim 256. Tolerances of tests/test_torch_train.py and
  tests/test_torch_retrievers.py: loss rtol 1e-5; gradients 1e-4 of
  max|ref| + 1e-7; parameters after the step rtol 1e-4 / atol 1e-6.

The windowed CUDA kernels themselves are held to the plain versions on the
card in test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cli_e2e import write_micro_dataset
from test_torch_gate_scatter import make_case, torch_layout
from test_torch_retrievers import (NUM_ENT, NUM_REL, check_model, synthetic_batch,
                                   to_port)

from gnn_rag_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from gnn_rag_tpu.data.loader import load_dataset_dir as jax_load_dataset_dir
from gnn_rag_tpu.models import ReaRev as JReaRev
from gnn_rag_tpu.models import encoders as jenc
from gnn_rag_tpu.models.nsm import NSM as JNSM
from gnn_rag_tpu.train.trainer import Trainer as JTrainer
from gnn_rag_tpu.utils.synthetic import random_rel_hidden
from gnn_rag_tpu_torch import bridge
from gnn_rag_tpu_torch.data.loader import load_dataset_dir
from gnn_rag_tpu_torch.models import encoders as tenc
from gnn_rag_tpu_torch.models.nsm import NSM
from gnn_rag_tpu_torch.ops import gate_scatter as gs
from gnn_rag_tpu_torch.train.trainer import Trainer

KEY = jax.random.PRNGKey(0)
WORD_DIM = 32
t = torch.from_numpy


def close(got, ref, rel, name=""):
    got, ref = got.double(), ref.double()
    err = (got - ref).abs().max().item()
    assert err <= rel * ref.abs().max().item() + 1e-7, (name, err)


# ------------------------------------------------------------ window plan
def windows(D, W):
    """The column ranges [c0, c1) of windows of width W over D columns, in
    window order, as the kernels take them."""
    return [(c0, min(c0 + W, D)) for c0 in range(0, D, W)]


@pytest.mark.parametrize("D,widest,itemsize,want", [
    (128, 102, 4, (64, 2)),     # K2 at CWQ's J 3, entity dim 128, float32
    (128, 115, 2, (64, 2)),     # the same in bf16 (8-value copies)
    (256, 211, 4, (128, 2)),    # K2 at J 1, entity dim 256 (NSM, TypeLayer)
    (384, 181, 4, (128, 3)),    # K1 at J 2, D 384
    (16, 11, 4, (8, 2)),        # K1 at J 40, D 16
    (512, 302, 4, (256, 2)),    # scatter_mm at C 512
    (303, 302, 4, (152, 2)),    # one column past the widest
    (363, 362, 2, (184, 2)),
    (256, 58, 4, (52, 5)),      # the last window takes the remainder
    (301, 150, 2, (104, 3)),    # an odd width
    (16, 3, 4, (3, 6)),         # below one copy (a huge J): any W that fits
])
def test_window_plan_covers_and_aligns(D, widest, itemsize, want):
    W, n = gs.window_plan(D, widest, itemsize)
    assert (W, n) == want
    spans = windows(D, W)
    assert len(spans) == n and spans[0][0] == 0 and spans[-1][1] == D
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))   # exact cover
    assert all(0 < c1 - c0 <= min(W, widest) for c0, c1 in spans)
    align = 16 // itemsize
    if widest >= align:   # every window but the last a whole copy
        assert all((c1 - c0) % align == 0 for c0, c1 in spans[:-1])
    # equal windows where they can be: no two differ by more than a copy,
    # but for the last one
    assert max(c1 - c0 for c0, c1 in spans) - min(
        c1 - c0 for c0, c1 in spans[:-1] or spans) <= align


@pytest.mark.parametrize("D,widest", [
    # today's shapes: D 50 at J 1-3, the tightest kernel's fit (K2 at J 3 in
    # float32: 102 columns) and wider; D 16 and 15 of the card tests
    (50, 102), (50, 50), (50, 302), (16, 16), (15, 139)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_window_plan_one_window_where_it_fits(D, widest, itemsize):
    assert gs.window_plan(D, widest, itemsize) == (D, 1)
    assert windows(D, D) == [(0, D)]


def test_window_plan_refuses_when_nothing_fits():
    with pytest.raises(ValueError, match="no column window"):
        gs.window_plan(128, 0, 4)
    with pytest.raises(ValueError, match="window"):
        gs.kernel_window("gate_scatter_fwd", 128, 3, torch.float32, window=129)
    assert gs.kernel_window("gate_scatter_bwd", 128, 3, torch.float32,
                            window=48) == (48, 3)


# ------------------------------------------------- window by window, plain
def window_inputs(J, D, seed=0):
    """A layout (E 512) and gate inputs of both directions, CPU tensors."""
    kl, x, E = make_case(J, D=D, E=512, F=1200, seed=seed)
    lay = torch_layout(kl)
    vals = (t(x["vals_f"]), t(x["vals_i"]))
    prior = (t(x["prior_f"]), t(x["prior_i"]))
    scatter = (lay.fwd.scatter, lay.inv.scatter)
    starts = (lay.fwd.chunk_starts, lay.inv.chunk_starts)
    return vals, t(x["ins"]), prior, scatter, starts, E


def cols(x, J, D, c0, c1):
    """The window [c0, c1) of each instruction of a j-major [..., J*D]."""
    return x.reshape(*x.shape[:-1], J, D)[..., c0:c1].reshape(
        *x.shape[:-1], J * (c1 - c0))


def put(out, x, J, D, c0, c1):
    """Write a window's j-major [..., J*(c1-c0)] into out's [..., J*D]."""
    out.reshape(*out.shape[:-1], J, D)[..., c0:c1] = x.reshape(
        *x.shape[:-1], J, c1 - c0)


# (J, D, W): CWQ's J 3 at 128 in two windows, J 1 at 256 in two, an
# uneven last window, J 40 at 16
COMPOSE = [(3, 128, 64), (1, 256, 128), (2, 40, 16), (40, 16, 8)]


@pytest.mark.parametrize("J,D,W", COMPOSE)
@pytest.mark.parametrize("relu", [True, False])
def test_plain_windows_compose_to_the_whole_width(J, D, W, relu):
    """K1's and K2's decomposition: the plain forward and backward run on
    each window's columns give the whole-width plain results, the forward,
    dvals and dins exactly, dprior as the windows' partials added in window
    order within 1e-6 of its largest entry."""
    vals, ins, prior, scatter, starts, E = window_inputs(J, D)
    B = ins.shape[0]
    g = torch.randn((2, B, E, J * D), generator=torch.Generator().manual_seed(1))
    whole = gs.gate_scatter_fwd_plain(vals, ins, prior, scatter, starts, relu)
    dv, dp, di = gs.gate_scatter_bwd_plain(vals, ins, prior, scatter, starts, g,
                                           relu)
    out = torch.full_like(whole, float("nan"))
    dvals = [torch.full_like(v, float("nan")) for v in dv]
    dins = torch.full_like(di, float("nan"))
    dprior = [torch.zeros_like(p) for p in dp]
    spans = windows(D, W)
    assert len(spans) > 1
    for c0, c1 in spans:
        v_w = tuple(v[..., c0:c1].contiguous() for v in vals)
        i_w = ins[..., c0:c1].contiguous()
        put(out, gs.gate_scatter_fwd_plain(v_w, i_w, prior, scatter, starts,
                                           relu), J, D, c0, c1)
        w_dv, w_dp, w_di = gs.gate_scatter_bwd_plain(
            v_w, i_w, prior, scatter, starts, cols(g, J, D, c0, c1).contiguous(),
            relu)
        for full, part in zip(dvals, w_dv):
            full[..., c0:c1] = part
        dins[..., c0:c1] = w_di
        for acc, part in zip(dprior, w_dp):
            acc += part                   # in window order, as the kernel
    assert torch.equal(out, whole)
    assert all(torch.equal(a, b) for a, b in zip(dvals, dv))
    assert torch.equal(dins, di)
    for a, b in zip(dprior, dp):
        close(a, b, 1e-6, "dprior")


@pytest.mark.parametrize("J,D,W", COMPOSE[:3])
def test_plain_fused_windows_compose_to_the_whole_width(J, D, W):
    """K6a/b's and K6c's decomposition (GNN_RAG_GATE_SCATTER=v2): a window
    projects rl's columns from the whole fact_rel rows and w's columns of
    the window; its forward columns, dw and db columns and dins columns are
    the whole-width ones exactly; dfact_rel (drl[:, win] @ w[:, win]^T)
    and dprior are the windows' partials added in window order, within
    1e-6 of their largest entry. scatter_mm (K6d) too, its columns exact."""
    vals, ins, prior, scatter, starts, E = window_inputs(J, D, seed=2)
    rng = np.random.default_rng(3)
    w = t((rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32))
    b = t((0.1 * rng.standard_normal(D)).astype(np.float32))
    args = (vals[0], w, b, ins, prior[0], scatter[0], starts[0])
    B = ins.shape[0]
    g = torch.randn((B, E, J * D), generator=torch.Generator().manual_seed(4))
    whole = gs.fused_gate_scatter_fwd_plain(*args)
    dfr, dw, db, di, dp = gs.fused_gate_scatter_bwd_plain(*args, g)
    out = torch.full_like(whole, float("nan"))
    parts = [torch.full_like(x, float("nan")) for x in (dw, db, di)]
    dfr_sum, dp_sum = torch.zeros_like(dfr), torch.zeros_like(dp)
    for c0, c1 in windows(D, W):
        wa = (vals[0], w[:, c0:c1].contiguous(), b[c0:c1].contiguous(),
              ins[..., c0:c1].contiguous(), *args[4:])
        put(out, gs.fused_gate_scatter_fwd_plain(*wa), J, D, c0, c1)
        x_dfr, x_dw, x_db, x_di, x_dp = gs.fused_gate_scatter_bwd_plain(
            *wa, cols(g, J, D, c0, c1).contiguous())
        parts[0][:, c0:c1], parts[1][c0:c1], parts[2][..., c0:c1] = x_dw, x_db, x_di
        dfr_sum += x_dfr                  # in window order, as the kernel
        dp_sum += x_dp
    assert torch.equal(out, whole)
    for got, want, name in zip(parts, (dw, db, di), ("dw", "db", "dins")):
        assert torch.equal(got, want), name
    close(dfr_sum, dfr, 1e-6, "dfact_rel")
    close(dp_sum, dp, 1e-6, "dprior")
    tiles = torch.from_numpy(np.ascontiguousarray(
        make_case(J, D=D, E=512, F=1200, seed=2)[0].fwd.chunk_tiles))
    sv = torch.randn((B, vals[0].shape[1], J * D),
                     generator=torch.Generator().manual_seed(5))
    sc = gs.scatter_mm_fwd_plain(sv, scatter[0], tiles, E)
    for c0, c1 in windows(J * D, W):
        assert torch.equal(gs.scatter_mm_fwd_plain(
            sv[..., c0:c1].contiguous(), scatter[0], tiles, E), sc[..., c0:c1])


# ----------------------------------------- the port at those widths vs JAX
@pytest.fixture(scope="module")
def cwq_wide(tmp_path_factory):
    """The micro dataset loaded by both packages at CWQ's instruction count
    and entity dim 128 (scripts/rearev_cwq.sh with --entity_dim 128,
    num_gnn cut to 2), shared frozen-LM states, one set of flax weights."""
    root = tmp_path_factory.mktemp("cwq_wide")
    write_micro_dataset(root)
    cfg = Config(
        data=DataConfig(name="webqsp", data_folder=str(root) + "/"),
        model=ModelConfig(entity_dim=128, num_iter=2, num_ins=3, num_gnn=2,
                          linear_dropout=0.0),
        train=TrainConfig(is_eval=False, batch_size=4, test_batch_size=4,
                          lr=5e-3, decay_rate=0.5, gradient_clip=1e-3,
                          checkpoint_dir=str(root / "ckpt"),
                          experiment_name="wide"))
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


@pytest.mark.parametrize("variant", ["v4", "v2"])
def test_rearev_train_step_at_cwq_width_matches_jax(cwq_wide, variant,
                                                    monkeypatch, tmp_path):
    """J 3 at D 128, where K2, K6a/b and K6c take two column windows on the
    card: the loss and every gradient of one batch (with a padding row), then
    one Adam step through both Trainers from the same weights, under the
    v4 op and the v2 fused-projection op (set before jax.jit traces)."""
    monkeypatch.setenv("GNN_RAG_GATE_SCATTER", variant)
    m = cwq_wide
    cfg = dataclasses.replace(m["cfg"], train=dataclasses.replace(
        m["cfg"].train, checkpoint_dir=str(tmp_path)))
    idx = [0, 1, 2]
    jbatch = m["jb"]["train"].make_batch(idx, build_layout=True, batch_pad_to=4)
    tbatch = m["tb"]["train"].make_batch(idx, batch_pad_to=4).to("cpu")
    assert tbatch.layout.fwd.scatter.shape[0] == 4
    jmodel = JReaRev(cfg=cfg.model, num_entity=m["num_entity"],
                     num_relation=m["nkr"])
    want_loss, jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.apply(
        p, jbatch, *m["rel"], training=True, rngs={"dropout": KEY})[0]))(
        m["params"])
    kw = dict(valid_data=None, test_data=None, num_entity=m["num_entity"],
              num_kb_relation=m["nkr"], rel_hidden=m["rel"][0],
              rel_hidden_inv=m["rel"][1], rel_text_mask=m["rel"][2])
    jtr = JTrainer(cfg, train_data=m["jb"]["train"], **kw)
    tr = Trainer(cfg, train_data=m["tb"]["train"], word_dim=WORD_DIM,
                 device="cpu", **kw)
    start = bridge.from_flax(m["params"])
    tr.model.load_state_dict(start)
    loss = tr.model(tbatch, *map(t, m["rel"]), training=True,
                    generator=torch.Generator().manual_seed(0))[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = bridge.from_flax(jgrads)
    got = dict(tr.model.named_parameters())
    assert set(want) == set(got)
    for name, gw in want.items():
        close(got[name].grad, gw, 1e-4, name)

    valid_w = np.array([1, 1, 1, 0], np.float32)
    params, _, jacc = jax.jit(jtr._train_step_impl)(
        m["params"], jtr.tx.init(m["params"]), KEY, jbatch,
        jnp.asarray(valid_w), (jnp.zeros((), jnp.float32),) * 4)
    acc = tr.train_step(tbatch, t(valid_w), torch.zeros(4))
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-5,
                               atol=1e-6)
    stepped = tr.model.state_dict()
    for name, w in bridge.from_flax(params).items():
        if name == "reasoning.score_func.bias":
            # a gradient of 0 up to rounding: Adam's step follows its sign
            assert (stepped[name] - start[name]).abs().max() <= cfg.train.lr
            continue
        np.testing.assert_allclose(stepped[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    tr.close()


@pytest.fixture(scope="module")
def batch():
    return synthetic_batch()


def test_nsm_at_entity_dim_256_matches_jax(batch):
    """NSM at entity dim 256 with the backward teacher (TypeLayer's two-
    direction J 1 launch and NSM's one-direction ones, K2 in two windows on
    the card): loss, answer distribution and every gradient."""
    jb, rel = batch
    cfg = ModelConfig(model_name="NSM", entity_dim=256, linear_dropout=0.0,
                      num_step=2, lambda_back=0.1, lambda_constrain=0.1)
    model = JNSM(cfg=cfg, num_entity=NUM_ENT, num_relation=NUM_REL)
    check_model(model, model.init(KEY, jb, *rel), jb, rel, NSM, cfg)


def test_type_layer_at_entity_dim_256_matches_jax(batch):
    """TypeLayer at 256 (one launch of both directions at J 1): its output
    and the gradient of its weights."""
    jb, _ = batch
    rng = np.random.default_rng(6)
    rel = rng.standard_normal((NUM_REL + 1, 256)).astype(np.float32)
    args = (rel, jb.heads, jb.rels, jb.tails, jb.fact_mask, 128,
            jb.fact_rel_weight)
    m = jenc.TypeLayer(256)
    p = m.init(KEY, *args, layout=jb.layout)

    def f(params):
        out = m.apply(params, *args, layout=jb.layout)
        return jnp.sum(jnp.sin(out)), out

    (_, want), jgrads = jax.value_and_grad(f, has_aux=True)(p)
    mod = tenc.TypeLayer(256, 256)
    mod.load_state_dict(bridge.from_flax(p))
    got = mod(t(rel), to_port(jb).layout, 128)
    torch.sin(got).sum().backward()
    close(got.detach(), torch.from_numpy(np.array(want)), 1e-5, "out")
    grads = bridge.from_flax(jgrads)
    for name, par in mod.named_parameters():
        close(par.grad, grads[name], 1e-4, name)
