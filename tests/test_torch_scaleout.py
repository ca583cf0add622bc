"""Scale-out of the port (``parallel.mesh``, ``llm.sharding``) on the CPU:
ranks are processes of ``torch.distributed`` over ``gloo``, spawned two or
four at a time, each spawn with its own timeout.

* The ReaRev Trainer at dp 2, tp 2 and dp 2 x tp 2 for 3 epochs from the
  JAX Trainer's initial weights (bridged): epoch losses rtol 1e-5 and
  parameters (rtol 1e-4, atol 1e-6: Adam divides by the gradients' RMS, so
  the dp sums' rounding moves an element whose gradients cancel by more
  than 1e-5 of it; tests/test_torch_train.py holds parameters after Adam
  steps the same way) against the port's one-process run, and the losses against JAX's
  ``Trainer(mesh=make_mesh(dp=2, tp=2))`` at the JAX mesh test's rtol 1e-3
  (tests/test_mesh_trainer.py:55); at dp 2 x tp 2 with linear, LSTM-free
  and fact dropout the same against one process (the masks are drawn for
  the global batch). The gradient norm before each step's clip is held to
  one process's (rtol 1e-4), as are the SFT's and each LoRA adapter's
  gradient norms: Adam's step barely changes when every gradient is scaled
  by one constant, so a dp sum where a mean belongs, or a tp gradient
  counted twice, shows in the norm and hardly in the losses or
  parameters. ``MIN_SHARD_SIZE`` 64 in the ranks shards 13 parameters over
  tp.
* The Evaluator over ``make_sharded_forward`` at dp 2 (the last batch
  padded): the same metrics and `.info` lines as one process; only rank 0
  writes.
* ``SFTTrainer`` at dp 2 x tp 2 (megatron tp) against one process and
  against JAX's mesh ``SFTTrainer`` (losses rtol 1e-4, atol 1e-5), its
  checkpoints written whole by rank 0; and at a tp that does not divide
  the head counts, which JAX's ``shard_llm_params`` meets by replicating:
  one kv head at tp 2 (k_proj and v_proj whole on each rank, their
  gradients each rank's part, summed over tp) and 3 heads at dp 2 x tp 2
  (the whole attention on each rank), losses and pre-clip norms against
  one process and the losses against JAX at the same tolerances.
* LoRA adapters on a tp-sharded base against the unsharded base (rtol 1e-4,
  atol 1e-5, tests/test_serving_lora.py:104), also with an MLP whose
  intermediate axis does not divide by tp (kept whole) under adapters, and
  with adapters on q_proj, k_proj and v_proj of a one-kv-head base at tp 2.
* ``shard_llm_`` at those tps, one process a rank without collectives:
  each rank's query heads read the kv head they read in the whole model,
  and the ranks' partial attention outputs add up to the whole one's.
* ``python -m torch.distributed.run --nproc_per_node 2 -m
  gnn_rag_tpu_torch ... --dp_size 2``: the CLI builds its mesh from the
  launcher's environment; its checkpoint equals the one-process CLI's.
* The sharding rules: ``param_axis`` against ``_param_spec`` and the LLM's
  ``param_spec`` against JAX's ``param_spec``, one case a rule.

JAX is imported only inside the tests, so the spawned ranks load torch
alone.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gnn_rag_tpu_torch.config import Config, ModelConfig, TrainConfig
from gnn_rag_tpu_torch.llm.model import LlamaConfig, build_llama
from gnn_rag_tpu_torch.parallel import mesh as pmesh
from gnn_rag_tpu_torch.utils.synthetic import random_records, random_rel_hidden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_REL, NUM_ENT, WORD_DIM = 8, 1000, 32
SPAWN_TIMEOUT = 240
# LlamaConfig.tiny(vocab_size=64) of the JAX package
TINY = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            intermediate=128, max_seq_len=512, dtype="float32")
SFT = dict(batch_size=8, total_steps=4, save_every=2, learning_rate=1e-3)
# TINY with head counts that tp 2 does not divide: one kv head (tp divides
# the 4 query heads, not it), and 3 heads of 16 (tp divides neither)
SFT_MODELS = {"tiny": TINY, "kv1": dict(TINY, n_kv_heads=1),
              "h3": dict(TINY, dim=48, n_heads=3, n_kv_heads=1)}
# (model, dp, tp) of the port's mesh runs of each: two ranks, then four
SFT_MESHES = {"kv1": (1, 2), "h3": (2, 2)}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ the inputs
def dataset(seed=7, n=16):
    """Both packages' generators draw the same records from one seed."""
    rng = np.random.default_rng(seed)
    ds = random_records(rng, n_questions=n, num_relation=NUM_REL,
                        n_entities_max=16, n_facts_max=40,
                        num_entity_global=NUM_ENT)
    ds.q_hidden = [rng.standard_normal((len(r.q_token_ids), WORD_DIM))
                   .astype(np.float32) * 0.5 for r in ds.records]
    return ds, random_rel_hidden(rng, NUM_REL + 1, 4, WORD_DIM)


def sequential(ds):
    """Every epoch in the split's order (the two packages shuffle from
    different generators)."""
    orig = ds.reset_batches
    ds.reset_batches = lambda **kw: orig(is_sequential=True)
    return ds


def rearev_config(tmp, drop=0.0):
    return Config(model=ModelConfig(entity_dim=16, num_iter=2, num_ins=2,
                                    num_gnn=2, linear_dropout=drop,
                                    fact_drop=drop),
                  train=TrainConfig(batch_size=8, test_batch_size=8, lr=5e-3,
                                    decay_rate=0.99, checkpoint_dir=tmp))


def port_trainer(state, mesh=None, drop=0.0):
    import logging

    from gnn_rag_tpu_torch.train.trainer import Trainer
    ds, rel = dataset()
    sequential(ds)
    tr = Trainer(rearev_config(tempfile.mkdtemp(), drop), train_data=ds,
                 valid_data=ds, test_data=ds, num_entity=NUM_ENT,
                 num_kb_relation=NUM_REL, rel_hidden=rel[0],
                 rel_hidden_inv=rel[1], rel_text_mask=rel[2],
                 word_dim=WORD_DIM, device="cpu", mesh=mesh,
                 logger=logging.getLogger("scaleout"))
    pmesh.load_full_state_(tr.model, {k: torch.from_numpy(v)
                                      for k, v in state.items()})
    return tr


def keep_norms(tr, norm):
    """Wrap ``tr.train_step`` to keep ``norm(tr)`` after every step; returns
    the list it fills. Adam's step barely changes when every gradient is
    scaled by one constant, so the gradients are held, not only the losses
    and parameters."""
    kept, step = [], tr.train_step

    def wrapped(*args):
        out = step(*args)
        kept.append(norm(tr))
        return out

    tr.train_step = wrapped
    return kept


def pre_clip_norm(tr):
    return float(tr.grad_norm)


def train3(tr):
    """3 epochs: (epoch losses, eval metrics, whole state, every step's
    gradient norm before the clip)."""
    norms = keep_norms(tr, pre_clip_norm)
    losses = [tr.train_epoch()[0] for _ in range(3)]
    ev = tr.evaluate(tr.test_data)
    state = {k: v.detach().numpy().copy() for k, v in tr.full_state().items()}
    tr.close()
    return losses, ev, state, norms


def sft_data():
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 60, (16, 24)).astype(np.int32)
    return tokens, (rng.random((16, 24)) < 0.7).astype(np.float32)


# ----------------------------------------------------- the rank programs
def job_trainer(mesh, dp, tp, state, drop=0.0):
    pmesh.MIN_SHARD_SIZE = 64          # shard the toy model's parameters
    m = pmesh.make_mesh(dp, tp, backend="gloo", device="cpu")
    tr = port_trainer(state, m, drop)
    out = train3(tr)
    return out + (sorted(tr.sharded),)


def job_evaluator(mesh, state):
    from gnn_rag_tpu_torch.train.evaluate import Evaluator
    from gnn_rag_tpu_torch.train.trainer import build_model, model_inputs
    m = pmesh.make_mesh(2, 1, backend="gloo", device="cpu")
    ds, rel = dataset(seed=4, n=12)
    cfg = rearev_config(None)
    model = build_model(cfg, NUM_ENT, NUM_REL, device="cpu", **model_inputs(
        cfg, q_hidden=True, rel_hidden=rel[0], word_dim=WORD_DIM))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    fwd = pmesh.make_sharded_forward(model, tuple(map(torch.from_numpy, rel)), m)
    path = os.path.join(tempfile.mkdtemp(), "test.info")
    ev = Evaluator(eps=0.95, num_entity=NUM_ENT, id2entity={}, num_iter=2)
    got = ev.evaluate(ds, fwd, 8, write_info=True, batch_pad_to=8,
                      info_path=path if m.rank == 0 else None)
    lines = open(path).read().splitlines() if os.path.exists(path) else None
    return got, lines


def job_sft(mesh, params, out, model="tiny"):
    from gnn_rag_tpu_torch.llm.sft import SFTConfig, SFTTrainer
    m = pmesh.make_mesh(*SFT_MESHES.get(model, (2, 2)), backend="gloo",
                        device="cpu")
    cfg = LlamaConfig(**SFT_MODELS[model])
    tr = SFTTrainer(cfg, SFTConfig(output_dir=out, **SFT),
                    params={k: torch.from_numpy(v) for k, v in params.items()},
                    device="cpu", mesh=m)
    norms = keep_norms(tr, pre_clip_norm)
    losses = tr.train(*sft_data(), steps=4, resume=False, log_every=100)
    again = SFTTrainer(cfg, SFTConfig(output_dir=out, **SFT),
                       device="cpu", mesh=m)
    assert again.maybe_resume() and again.step == 4
    for (name, a), b in zip(tr.model.state_dict().items(),
                            again.model.state_dict().values()):
        assert torch.equal(a, b), name
    return losses, sorted(os.listdir(out)), norms


# the adapted weights, the changes to TINY and the tensors tp 2 shards of
# each LoRA case: an intermediate of 129 does not divide by tp 2, so
# gate/up/down stay whole on every tp rank; one kv head keeps k_proj and
# v_proj whole, each rank's gradient of them (and of their adapters) its
# part
LORA_CASES = {"q-v": (("q_proj", "v_proj"), {}, 2 * 7 + 2),
              "whole-mlp": (("q_proj", "v_proj", "gate_proj", "down_proj"),
                            {"intermediate": 129}, 2 * 4 + 2),
              "kv1": (("q_proj", "k_proj", "v_proj"), {"n_kv_heads": 1},
                      2 * 5 + 2)}


def lora_losses(mesh=None, case="q-v"):
    from gnn_rag_tpu_torch.llm.lora import LoRATrainer, init_lora
    from gnn_rag_tpu_torch.llm.sharding import partial_grad_names, shard_llm_
    targets, changes, n_sharded = LORA_CASES[case]
    tokens, mask = sft_data()
    model = build_llama(LlamaConfig(**dict(TINY, **changes)), seed=0,
                        device="cpu")
    lora = init_lora(model, torch.Generator().manual_seed(1), r=4,
                     targets=targets)
    if mesh is not None:
        assert len(shard_llm_(model, mesh)) == n_sharded
        assert len(partial_grad_names(model)) == (4 if case == "kv1" else 0)
    tr = LoRATrainer(model, lora, lr=1e-2, alpha=16, r=4, mesh=mesh)
    norms = keep_norms(tr, lambda t: [float(p.grad.norm()) for p in t.params])
    t, k = torch.from_numpy(tokens[:8]).long(), torch.from_numpy(mask[:8])
    if mesh is not None:
        rows = pmesh.batch_sharding(mesh, 8)
        t, k = t[rows], k[rows]
    return [float(tr.train_step(t, k)) for _ in range(5)], norms


def job_lora(mesh, case="q-v"):
    return lora_losses(pmesh.make_mesh(1, 2, backend="gloo", device="cpu"),
                       case)


JOBS = {"trainer": job_trainer, "evaluator": job_evaluator, "sft": job_sft,
        "lora": job_lora}


def rank_main(rank, world, port, jobs, queue):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        out = [JOBS[name](None, *args) for name, args in jobs]
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()


def spawn(world, jobs):
    """Run ``jobs`` [(name, args)] on ``world`` fresh ranks; returns each
    rank's results. Fails on a rank's error or at SPAWN_TIMEOUT."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, world, port, jobs, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=SPAWN_TIMEOUT) for _ in range(world))
        for p in procs:
            p.join(timeout=60)
            assert p.exitcode == 0, p.exitcode
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(world)]


# ----------------------------------------------------------- the fixture
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX mesh runs and the port's one-process runs here, the port's
    mesh runs in two spawns (2 ranks, then 4)."""
    import jax

    from gnn_rag_tpu.llm_tpu.model import LlamaConfig as JLlamaConfig
    from gnn_rag_tpu.llm_tpu.sft import SFTConfig as JSFTConfig
    from gnn_rag_tpu.llm_tpu.sft import SFTTrainer as JSFTTrainer
    from gnn_rag_tpu.parallel.mesh import make_mesh as jmake_mesh
    from gnn_rag_tpu.train.trainer import Trainer as JTrainer
    from gnn_rag_tpu.utils import synthetic as jsynthetic
    from gnn_rag_tpu_torch import bridge
    from gnn_rag_tpu_torch.llm.sft import SFTConfig, SFTTrainer

    tmp = tmp_path_factory.mktemp("scaleout")
    jmesh = jmake_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    rng = np.random.default_rng(7)
    jds = jsynthetic.random_records(rng, n_questions=16, num_relation=NUM_REL,
                                    n_entities_max=16, n_facts_max=40,
                                    num_entity_global=NUM_ENT)
    jds.q_hidden = [rng.standard_normal((len(r.q_token_ids), WORD_DIM))
                    .astype(np.float32) * 0.5 for r in jds.records]
    rel = jsynthetic.random_rel_hidden(rng, NUM_REL + 1, 4, WORD_DIM)
    sequential(jds)
    jtr = JTrainer(rearev_config(str(tmp / "j")), train_data=jds,
                   valid_data=jds, test_data=jds, num_entity=NUM_ENT,
                   num_kb_relation=NUM_REL, rel_hidden=rel[0],
                   rel_hidden_inv=rel[1], rel_text_mask=rel[2], mesh=jmesh)
    state = {k: v.numpy() for k, v in bridge.from_flax(jtr.params).items()}
    with jmesh:
        jax_losses = [jtr.train_epoch()[0] for _ in range(3)]

    def sft_runs(model):
        """(the JAX trainer's weights as a state_dict, its losses on the
        mesh, the port's one-process losses and pre-clip norms)."""
        jsft = JSFTTrainer(JLlamaConfig(**SFT_MODELS[model]),
                           JSFTConfig(output_dir=str(tmp / f"jsft-{model}"),
                                      **SFT), mesh=jmesh)
        params = {k: v.numpy() for k, v in
                  bridge.llama_from_flax(jsft.params).items()}
        with jmesh:
            jax_losses = jsft.train(*sft_data(), steps=4, resume=False,
                                    log_every=100)
        one = SFTTrainer(LlamaConfig(**SFT_MODELS[model]),
                         SFTConfig(output_dir=str(tmp / f"sft1-{model}"),
                                   **SFT),
                         params={k: torch.from_numpy(v)
                                 for k, v in params.items()}, device="cpu")
        norms = keep_norms(one, pre_clip_norm)
        return params, jax_losses, (one.train(*sft_data(), steps=4,
                                              resume=False, log_every=100),
                                    norms)

    assert JLlamaConfig(**TINY) == JLlamaConfig.tiny(vocab_size=64)
    sft_models = {model: sft_runs(model) for model in SFT_MODELS}
    llm_params, jax_sft, one_sft = sft_models["tiny"]

    one = {drop: train3(port_trainer(state, drop=drop)) for drop in (0.0, 0.2)}
    two = spawn(2, [("trainer", (2, 1, state)), ("trainer", (1, 2, state)),
                    ("evaluator", (state,)), ("lora", ()),
                    ("lora", ("whole-mlp",)), ("lora", ("kv1",)),
                    ("sft", (sft_models["kv1"][0], str(tmp / "sft2-kv1"),
                             "kv1"))])
    four = spawn(4, [("trainer", (2, 2, state)),
                     ("trainer", (2, 2, state, 0.2)),
                     ("sft", (llm_params, str(tmp / "sft4"))),
                     ("sft", (sft_models["h3"][0], str(tmp / "sft4-h3"),
                              "h3"))])
    return dict(jax_losses=jax_losses, jax_sft=jax_sft, one_sft=one_sft,
                one=one, two=two, four=four, state=state,
                sft_models=sft_models)


def check_trainer(got, want):
    losses, ev, state, norms, sharded = got
    np.testing.assert_allclose(losses, want[0], rtol=1e-5)
    np.testing.assert_allclose(ev, want[1], rtol=1e-5)
    assert len(norms) == len(want[3]) == 6
    np.testing.assert_allclose(norms, want[3], rtol=1e-4)
    assert set(state) == set(want[2])
    for name, w in want[2].items():
        if name in ("reasoning.score_func.bias",
                    "instruction_decoder.ca_linear.bias"):
            # a bias before a softmax gets a gradient of 0 up to rounding,
            # so Adam's normalised step follows the sign of rounding noise:
            # bounded by the 6 steps' rate only
            assert np.abs(state[name] - w).max() <= 2 * 6 * 5e-3, name
            continue
        np.testing.assert_allclose(state[name], w, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    return sharded


@pytest.mark.parametrize("case", ["dp2", "tp2", "dp2xtp2", "dp2xtp2-dropout"])
def test_trainer_matches_one_process(runs, case):
    got = {"dp2": runs["two"][0][0], "tp2": runs["two"][0][1],
           "dp2xtp2": runs["four"][0][0],
           "dp2xtp2-dropout": runs["four"][0][1]}[case]
    want = runs["one"][0.2 if case.endswith("dropout") else 0.0]
    sharded = check_trainer(got, want)
    assert (len(sharded) == 13) == ("tp2" in case), sharded
    # every rank of the mesh ends with the same whole parameters
    ranks = runs["two"] if case in ("dp2", "tp2") else runs["four"]
    k = {"dp2": 0, "tp2": 1, "dp2xtp2": 0, "dp2xtp2-dropout": 1}[case]
    for out in ranks[1:]:
        for name, w in got[2].items():
            np.testing.assert_array_equal(out[k][2][name], w, err_msg=name)


@pytest.mark.parametrize("case", ["dp2", "tp2", "dp2xtp2"])
def test_trainer_matches_jax_mesh_trainer(runs, case):
    got = {"dp2": runs["two"][0][0], "tp2": runs["two"][0][1],
           "dp2xtp2": runs["four"][0][0]}[case]
    np.testing.assert_allclose(got[0], runs["jax_losses"], rtol=1e-3)


def test_sharded_evaluator_matches_one_process(runs):
    from gnn_rag_tpu_torch.train.evaluate import Evaluator
    from gnn_rag_tpu_torch.train.trainer import build_model, model_inputs
    ds, rel = dataset(seed=4, n=12)
    cfg = rearev_config(None)
    model = build_model(cfg, NUM_ENT, NUM_REL, device="cpu", **model_inputs(
        cfg, q_hidden=True, rel_hidden=rel[0], word_dim=WORD_DIM))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in runs["state"].items()})
    rel_t = tuple(map(torch.from_numpy, rel))
    path = os.path.join(tempfile.mkdtemp(), "test.info")
    want = Evaluator(eps=0.95, num_entity=NUM_ENT, id2entity={},
                     num_iter=2).evaluate(ds, lambda b: model(b.to("cpu"), *rel_t),
                                          8, write_info=True, info_path=path)
    (got, lines), (_, none) = runs["two"][0][2], runs["two"][1][2]
    assert none is None                       # rank 1 wrote nothing
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-5)
    ref = [json.loads(x) for x in open(path)]
    got_lines = [json.loads(x) for x in lines]
    assert len(got_lines) == len(ref) == 12
    for a, b in zip(got_lines, ref):
        assert list(a) == list(b)
        assert [c for c, _ in a["cand"]] == [c for c, _ in b["cand"]]
        np.testing.assert_allclose([p for _, p in a["cand"]],
                                   [p for _, p in b["cand"]], rtol=1e-5)


def test_sft_matches_one_process_and_jax_mesh(runs):
    losses, files, norms = runs["four"][0][2]
    np.testing.assert_allclose(losses, runs["one_sft"][0], rtol=1e-5)
    np.testing.assert_allclose(norms, runs["one_sft"][1], rtol=1e-4)
    np.testing.assert_allclose(losses, runs["jax_sft"], rtol=1e-4, atol=1e-5)
    assert files == ["checkpoint-2.pt", "checkpoint-4.pt"]


@pytest.mark.parametrize("model", ["kv1", "h3"])
def test_sft_at_a_tp_that_does_not_divide_the_heads(runs, model):
    """One kv head at tp 2 (k_proj and v_proj whole on each rank, each
    rank's gradient of them its part, summed over tp: divided by tp, the
    pre-clip norms would miss by their share), and 3 heads at dp 2 x tp 2
    (the whole attention on each rank, its gradients divided by tp): the
    losses and pre-clip gradient norms of one process, and JAX's losses on
    its mesh, where ``shard_llm_params`` replicates what does not divide."""
    _, jax_losses, (one_losses, one_norms) = runs["sft_models"][model]
    got = runs["two"][0][6] if model == "kv1" else runs["four"][0][3]
    losses, files, norms = got
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, one_norms, rtol=1e-4)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4, atol=1e-5)
    assert files == ["checkpoint-2.pt", "checkpoint-4.pt"]
    assert losses[-1] < losses[0]


def test_lora_on_tp_sharded_base_matches_unsharded(runs):
    got, norms = runs["two"][0][3]
    want, want_norms = lora_losses()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-4)
    assert got[-1] < got[0]


def test_lora_on_tp_base_with_whole_mlp_matches_unsharded(runs):
    """Adapters on gate/down, which tp leaves whole: each tp rank holds
    their whole gradient, so it is not counted tp times."""
    got, norms = runs["two"][0][4]
    want, want_norms = lora_losses(case="whole-mlp")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-4)
    assert got[-1] < got[0]


def test_lora_on_tp_base_with_one_kv_head_matches_unsharded(runs):
    """Adapters on q_proj, k_proj and v_proj of a one-kv-head base at tp 2:
    k_proj and v_proj stay whole, and each tp rank's gradient of their
    adapters is its query heads' part, summed over tp, not divided by it."""
    got, norms = runs["two"][0][5]
    want, want_norms = lora_losses(case="kv1")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-4)
    assert got[-1] < got[0]


def test_cli_runs_under_torchrun(tmp_path):
    """Two ranks of ``torch.distributed.run`` train the CLI at dp 2 (LSTM
    and linear dropout on) and save the same final checkpoint as one
    process; rank 0 alone writes the log file."""
    from test_cli_e2e import write_micro_dataset
    (tmp_path / "data").mkdir()
    write_micro_dataset(tmp_path / "data")
    flags = ["ReaRev", "--data_folder", str(tmp_path / "data") + "/",
             "--lm", "lstm", "--relation_word_emb", "False", "--entity_dim",
             "16", "--num_iter", "2", "--num_ins", "2", "--num_gnn", "2",
             "--batch_size", "4", "--test_batch_size", "4", "--num_epoch",
             "2", "--eval_every", "2", "--device", "cpu",
             "--experiment_name", "x"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    one = subprocess.run([sys.executable, "-m", "gnn_rag_tpu_torch", *flags,
                          "--checkpoint_dir", str(tmp_path / "one")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
         "-m", "gnn_rag_tpu_torch", *flags, "--checkpoint_dir",
         str(tmp_path / "two"), "--dp_size", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert two.returncode == 0, two.stderr[-3000:]
    assert two.stdout.count("mesh: dp=2 tp=1") == 2
    log = open(tmp_path / "two" / "gnn_rag_tpu_torch.log").read()
    assert log.count("mesh: dp=2 tp=1") == 1
    want = torch.load(tmp_path / "one" / "x-final.ckpt", weights_only=True)
    got = torch.load(tmp_path / "two" / "x-final.ckpt", weights_only=True)
    assert set(got) == set(want)
    for name, w in want.items():
        if name in ("reasoning.score_func.bias",
                    "instruction_decoder.ca_linear.bias"):
            continue          # rounding noise under Adam (check_trainer)
        torch.testing.assert_close(got[name], w, rtol=1e-4, atol=1e-6)


def test_make_mesh_needs_a_process_group(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        pmesh.make_mesh(2, 1, device="cpu")


class FakeMesh(pmesh.Mesh):
    """A mesh's coordinates without a process group (for the row and
    dropout arithmetic)."""

    def __init__(self, dp, tp, rank):
        super().__init__(dp=dp, tp=tp, rank=rank, device=torch.device("cpu"),
                         dp_group=None, tp_group=None)


# (n_heads, n_kv_heads, tp): tp divides the heads and not the kv heads
# (two of the four ranks on each kv head; two ranks on one kv head), or
# neither
TP_HEADS = {"h8-kv2-tp4": (8, 2, 4), "h4-kv1-tp2": (4, 1, 2),
            "h3-kv1-tp2": (3, 1, 2)}


@pytest.mark.parametrize("case", list(TP_HEADS))
def test_shard_llm_keeps_the_whole_models_kv_heads(case):
    """``shard_llm_`` no longer refuses a tp that does not divide the head
    counts. Where tp divides the query heads, each rank's heads read the kv
    head they read in the whole model (the whole model's GQA repeat, sliced
    to the rank's heads), k_proj and v_proj stay whole and their gradients
    are partial; the ranks' attention outputs before the all-reduce add up
    to the whole attention's. Where it does not, the attention stays whole
    on every rank and the MLP is still cut."""
    from gnn_rag_tpu_torch.llm.model import rope_frequencies
    from gnn_rag_tpu_torch.llm.sharding import (kv_heads_of_rank,
                                                partial_grad_names,
                                                shard_llm_)
    H, KV, tp = TP_HEADS[case]
    cfg = LlamaConfig(**dict(TINY, dim=8 * H, n_heads=H, n_kv_heads=KV))
    whole = build_llama(cfg, seed=3, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 10, cfg.dim)).astype(np.float32))
    cos, sin = rope_frequencies(cfg.head_dim, torch.arange(10)[None].expand(
        2, 10), cfg.rope_theta, cfg.rope_condense)
    with torch.no_grad():
        want, _ = whole.layer_0.attn(x, cos, sin)
    total = 0
    for rank in range(tp):
        model = build_llama(cfg, seed=3, device="cpu")
        sharded = shard_llm_(model, FakeMesh(1, tp, rank))
        attn = model.layer_0.attn
        assert model.layer_0.mlp.tp is not None
        if H % tp:
            assert attn.tp is None and attn.kv_index is None
            assert not any(".attn." in n for n in sharded)
            assert partial_grad_names(model) == frozenset()
            continue
        heads = torch.arange(KV).repeat_interleave(H // KV)
        local = heads[rank * H // tp:(rank + 1) * H // tp].tolist()
        assert kv_heads_of_rank(H, KV, tp, rank) == local
        assert attn.kv_index.tolist() == local
        assert attn.n_heads == H // tp and attn.n_kv_heads == KV
        assert attn.k_proj.weight.shape == (KV * cfg.head_dim, cfg.dim)
        assert attn.q_proj.weight.shape == (H // tp * cfg.head_dim, cfg.dim)
        assert partial_grad_names(model) == frozenset(
            f"layer_{i}.attn.{p}.weight" for i in range(2)
            for p in ("k_proj", "v_proj"))
        attn.tp = None            # this rank's part, before the all-reduce
        with torch.no_grad():
            total = total + attn(x, cos, sin)[0]
    if H % tp == 0:
        torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-6)


def test_shard_batch_takes_each_ranks_rows_of_the_global_batch():
    """Each rank's rows of every leaf; its layout is the one its rows build
    at the global buckets (``pack_samples`` of those rows' own samples)."""
    from gnn_rag_tpu_torch.data.kernel_layout import pack_samples
    ds, _ = dataset()
    batch = ds.make_batch(list(range(6)), batch_pad_to=8)
    E = batch.layout.num_entities
    nc = batch.layout.fwd.chunk_tiles.shape[1]
    for rank in range(4):
        part = pmesh.shard_batch(FakeMesh(2, 2, rank), batch)
        rows = slice(4 * (rank // 2), 4 * (rank // 2) + 4)
        np.testing.assert_array_equal(part.heads, batch.heads[rows])
        np.testing.assert_array_equal(part.q_hidden, batch.q_hidden[rows])
        for a, b in zip(part.layout.fwd + part.layout.inv,
                        batch.layout.fwd + batch.layout.inv):
            np.testing.assert_array_equal(a, b[rows])
        assert part.layout.num_entities == E
    own = [ds.records[i].kl_cache[E] for i in range(4)]
    rebuilt = pack_samples([f for f, _ in own], [i for _, i in own], E,
                           NUM_REL, num_chunks=nc)
    first = pmesh.shard_batch(FakeMesh(2, 1, 0), batch).layout
    for a, b in zip(first.fwd + first.inv, rebuilt.fwd + rebuilt.inv):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="batch_pad_to"):
        pmesh.shard_batch(FakeMesh(4, 1, 0), ds.make_batch([0, 1, 2]))


def test_shard_rel_hidden_keeps_this_ranks_rows():
    table = torch.arange(6 * 2 * 3, dtype=torch.float32).reshape(6, 2, 3)
    for rank in range(2):
        torch.testing.assert_close(
            pmesh.shard_rel_hidden(FakeMesh(1, 2, rank), table),
            table[3 * rank:3 * rank + 3])
    assert pmesh.shard_rel_hidden(FakeMesh(1, 4, 1), table) is table
    assert pmesh.shard_rel_hidden(FakeMesh(1, 2, 0), None) is None


def test_row_shard_draws_the_global_batchs_masks():
    from gnn_rag_tpu_torch.models.encoders import RowShard, bernoulli_keep
    one = torch.Generator().manual_seed(3)
    want = [bernoulli_keep(s, 0.7, one, "cpu") for s in ((8, 5, 3), (9, 2))]
    for index in range(2):
        g = RowShard(torch.Generator().manual_seed(3), 2, index, 4)
        torch.testing.assert_close(bernoulli_keep((4, 5, 3), 0.7, g, "cpu"),
                                   want[0][4 * index:4 * index + 4])
        # a mask whose first axis is not the rows is drawn whole
        torch.testing.assert_close(bernoulli_keep((9, 2), 0.7, g, "cpu"),
                                   want[1])


# one case per rule of _param_spec (gnn_rag_tpu/parallel/mesh.py:52-63)
AXIS_CASES = {
    "scalar": ((), 2, 1, None),
    "small": ((64, 32), 2, 16_384, None),
    "tp1": ((512, 64), 1, 16, None),
    "largest-axis": ((64, 512), 2, 16, 1),
    "largest-does-not-divide": ((513, 64), 2, 16, 1),
    "too-narrow-for-tp": ((4, 4096), 1024, 16, None),
    "none-divides": ((33, 35), 2, 16, None),
    "tie-takes-first": ((64, 64), 2, 16, 0),
}


@pytest.mark.parametrize("case", list(AXIS_CASES))
def test_param_axis_matches_jax_param_spec(case):
    from gnn_rag_tpu.parallel.mesh import _param_spec
    shape, tp, min_size, want = AXIS_CASES[case]
    got = pmesh.param_axis(shape, tp, min_size)
    spec = tuple(_param_spec("", np.zeros(shape), tp, min_size))
    jax_axis = next((a for a, s in enumerate(spec) if s == "tp"), None)
    assert got == jax_axis == want


# (port state_dict name, shape [out, in] or as stored; JAX path, JAX shape)
LLM_CASES = {
    "tok_emb": ("tok_emb.weight", (64, 32), "['params']['tok_emb']['embedding']", (64, 32)),
    "lm_head": ("lm_head.weight", (64, 32), "['params']['lm_head']['kernel']", (64, 32)),
    "lm_head-int8": ("lm_head.weight_q", (64, 32), "['params']['lm_head']['kernel_q']", (32, 64)),
    "q_proj": ("layer_0.attn.q_proj.weight", (64, 32), "['params']['layer_0']['attn']['q_proj']['kernel']", (64, 32)),
    "k_proj-int8": ("layer_0.attn.k_proj.weight_q", (64, 32), "['params']['layer_0']['attn']['k_proj']['kernel_q']", (32, 64)),
    "o_proj": ("layer_0.attn.o_proj.weight", (32, 64), "['params']['layer_0']['attn']['o_proj']['kernel']", (32, 64)),
    "gate_proj": ("layer_0.mlp.gate_proj.weight", (128, 32), "['params']['layer_0']['mlp']['gate_proj']['kernel']", (128, 32)),
    "down_proj-int8": ("layer_0.mlp.down_proj.weight_q", (32, 128), "['params']['layer_0']['mlp']['down_proj']['kernel_q']", (128, 32)),
    "norm": ("layer_0.input_norm.scale", (32,), "['params']['layer_0']['input_norm']['scale']", (32,)),
}


@pytest.mark.parametrize("case", list(LLM_CASES))
def test_llm_param_spec_matches_jax(case):
    """The same megatron axis as JAX's spec: JAX's int8 ``kernel_q`` is
    ``[in, out]`` where the port keeps ``[out, in]``, so its axis flips."""
    from gnn_rag_tpu.llm_tpu.sharding import param_spec as jparam_spec
    from gnn_rag_tpu_torch.llm.sharding import param_spec
    name, shape, jpath, jshape = LLM_CASES[case]
    spec = tuple(jparam_spec(jpath, np.zeros(jshape)))
    jax_axis = next((a for a, s in enumerate(spec) if s == "tp"), None)
    got = param_spec(name, shape)
    if jax_axis is not None and shape != jshape:
        jax_axis = 1 - jax_axis
    assert got == jax_axis
