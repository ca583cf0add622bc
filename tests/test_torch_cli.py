"""The port's entry point, ``python -m gnn_rag_tpu_torch``, on the CPU: two
training epochs on the micro dataset write the best-h1/f1/final checkpoints
and their provenance sidecars; ``--is_eval --load_experiment`` writes a
`.info` whose lines have the JAX package's keys; ``--device cuda`` without a
card raises; of the flags the port once refused, ``--dp_size`` above 1
needs a process group (a ``torchrun`` launch: tests/test_torch_scaleout.py
runs one) and raises without one, the others now evaluate (``--info_attention`` is ported too:
tests/test_torch_rag.py holds its `.info` to the JAX Evaluator's;
tests/test_torch_rearev_options.py and test_torch_retrievers.py hold the
options and the other retrievers to the JAX package)."""

import json
import os
import subprocess
import sys

import pytest
import torch
from test_cli_e2e import write_micro_dataset

from gnn_rag_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the headline's frozen LM (sbert, MiniLM widths) on a narrow ReaRev
FLAGS = ["ReaRev", "--lm", "sbert", "--entity_dim", "16", "--num_iter", "2",
         "--num_ins", "2", "--num_gnn", "2", "--batch_size", "4",
         "--test_batch_size", "4", "--experiment_name", "micro"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    (root / "data").mkdir()
    write_micro_dataset(root / "data")
    args = FLAGS + ["--data_folder", str(root / "data") + "/",
                    "--checkpoint_dir", str(root / "ckpt")]
    proc = subprocess.run(
        [sys.executable, "-m", "gnn_rag_tpu_torch", *args, "--device", "cpu",
         "--num_epoch", "2", "--eval_every", "1", "--lr", "0.003",
         "--decay_rate", "0.98"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return root, args, proc.stdout


def test_train_writes_checkpoints_and_sidecars(trained):
    root, _, out = trained
    names = set(os.listdir(root / "ckpt"))
    for reason in ("h1", "f1", "final"):
        assert f"micro-{reason}.ckpt" in names, names
        meta = json.loads((root / "ckpt" / f"micro-{reason}.ckpt.meta.json").read_text())
        assert meta["model"] == "ReaRev" and meta["lm"] == "sbert"
        assert meta["lm_weight_source"].startswith("random-init")
    assert out.count("Epoch: ") == 2 and out.count("TEST F1") >= 2
    state = torch.load(root / "ckpt" / "micro-final.ckpt", weights_only=True)
    assert "reasoning.e2e_linear0.weight" in state


def test_eval_writes_info_with_jax_keys(trained):
    root, args, _ = trained
    ctx = cli.run(args + ["--device", "cpu", "--is_eval",
                          "--load_experiment", "micro-final.ckpt"])
    info = root / "ckpt" / "micro_test.info"
    lines = [json.loads(line) for line in open(info)]
    assert len(lines) == ctx["trainer"].test_data.num_data == 2
    keys = ["question", "0", "1", "answers", "precison", "recall", "f1",
            "hit", "em", "cand"]
    assert all(list(line) == keys for line in lines)
    assert all(isinstance(c, list) and len(c) == 2 for c in lines[0]["cand"])
    meta = json.loads(open(str(info) + ".meta.json").read())
    assert meta["experiment_name"] == "micro"
    # the checkpoint was loaded: the model holds the final weights
    want = torch.load(root / "ckpt" / "micro-final.ckpt", weights_only=True)
    got = ctx["trainer"].model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())


def test_cuda_without_a_card_raises(trained, monkeypatch):
    root, args, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        cli.run(args)                                # --device cuda by default


@pytest.mark.parametrize("extra", [["--num_workers", "2"], ["--lm", "lstm"],
                                   ["--dp_size", "2"], ["--pos_emb"],
                                   ["--relation_word_emb", "False"]])
def test_unported_flags_raise(trained, extra):
    """``--dp_size 2`` (scale-out) raises outside a ``torchrun`` launch (no
    process group to build its mesh on); each other flag once refused now
    runs the eval-only entry and writes the `.info` (checkpoint tensors
    whose shape no longer fits, e.g. the LSTM's, keep their init)."""
    root, args, _ = trained
    argv = args + ["--device", "cpu", "--is_eval", "--load_experiment",
                   "micro-final.ckpt", "--experiment_name", "opt"] + extra
    if extra == ["--dp_size", "2"]:
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE")}
        proc = subprocess.run([sys.executable, "-m", "gnn_rag_tpu_torch", *argv],
                              cwd=REPO, env=dict(env, PYTHONPATH=REPO),
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert "make_mesh: no process group" in proc.stderr, proc.stderr[-2000:]
        return
    ctx = cli.run(argv)
    lines = [json.loads(x) for x in open(root / "ckpt" / "opt_test.info")]
    assert len(lines) == 2 and all(line["cand"] for line in lines)
    assert (ctx["lm"] is None) == (extra == ["--relation_word_emb", "False"])
