"""The port's pretrained frozen-LM path on the CPU, against HuggingFace and
the JAX package: tiny bert, roberta, t5 and mpnet models built in-process
(random init, no network) and ``save_pretrained`` to tmp, then
``load_hf_encoder`` / ``FrozenLM.from_hf`` of the port (which reads the
files without ``transformers``) held to the HF forward and to the JAX
package's ``FrozenLM.from_hf`` at 1e-4 on unpadded positions; the
checkpoint also as ``pytorch_model.bin`` and found through the hub cache;
``maybe_frozen_lm``'s loud fallback; and the port's CLI on the micro dataset
with a tiny bert (and its tokenizer) installed as ``--lm sbert``, whose
`.info` questions are the decoded word pieces."""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from test_cli_e2e import write_micro_dataset  # noqa: E402

from gnn_rag_tpu.models.frozen_lm import FrozenLM as JFrozenLM  # noqa: E402
from gnn_rag_tpu_torch.models import encoder_variants  # noqa: E402
from gnn_rag_tpu_torch.models.encoders import TransformerQuestionEncoder  # noqa: E402
from gnn_rag_tpu_torch.models.frozen_lm import FrozenLM, maybe_frozen_lm  # noqa: E402
from gnn_rag_tpu_torch.utils import hf_import  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny(arch):
    """(HF model, pad id, vocab) of a tiny random model of ``arch``."""
    t = transformers
    torch.manual_seed(0)
    if arch == "bert":
        cfg = t.BertConfig(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                           num_attention_heads=4, intermediate_size=64,
                           max_position_embeddings=48)
        return t.BertModel(cfg), 0, 120
    if arch == "roberta":
        cfg = t.RobertaConfig(vocab_size=100, hidden_size=32,
                              num_hidden_layers=2, num_attention_heads=4,
                              intermediate_size=64,
                              max_position_embeddings=52, pad_token_id=1)
        return t.RobertaModel(cfg), 1, 100
    if arch == "t5":
        cfg = t.T5Config(vocab_size=80, d_model=32, num_layers=2, num_heads=4,
                         d_kv=8, d_ff=64)
        return t.T5EncoderModel(cfg), 0, 80
    cfg = t.MPNetConfig(vocab_size=90, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64,
                        max_position_embeddings=60)
    return t.MPNetModel(cfg), 1, 90


def inputs(vocab, pad):
    rng = np.random.default_rng(0)
    tokens = rng.integers(2, vocab, size=(3, 10)).astype(np.int64)
    mask = np.ones((3, 10), np.int64)
    mask[0, 7:] = 0
    mask[2, 4:] = 0
    tokens[mask == 0] = pad
    return tokens, mask


MODULES = {"bert": TransformerQuestionEncoder,
           "roberta": TransformerQuestionEncoder,
           "t5": encoder_variants.T5Encoder,
           "mpnet": encoder_variants.MPNetEncoder}


@pytest.mark.parametrize("arch", ["bert", "roberta", "t5", "mpnet"])
@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_from_hf_matches_hf_and_jax(arch, fmt, tmp_path):
    model, pad, vocab = tiny(arch)
    model.eval()
    model.save_pretrained(tmp_path, safe_serialization=fmt == "safetensors")
    assert os.path.exists(tmp_path / ("model.safetensors" if fmt == "safetensors"
                                      else "pytorch_model.bin"))
    tokens, mask = inputs(vocab, pad)
    lm = FrozenLM.from_hf(str(tmp_path), device="cpu")
    assert type(lm.module) is MODULES[arch] and lm.hidden == 32
    if arch == "roberta":
        assert lm.module.position_style == "roberta" and lm.module.pad_idx == 1
    ours = lm.encode(tokens.astype(np.int32), mask=mask.astype(np.float32))
    with torch.no_grad():
        theirs = model(input_ids=torch.from_numpy(tokens),
                       attention_mask=torch.from_numpy(mask)
                       ).last_hidden_state.numpy()
    jax_lm = JFrozenLM.from_hf(str(tmp_path))
    ref = jax_lm.encode(tokens.astype(np.int32), mask=mask.astype(np.float32))
    valid = mask.astype(bool)
    np.testing.assert_allclose(ours[valid], theirs[valid], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours[valid], ref[valid], rtol=1e-4, atol=1e-4)


def test_load_hf_encoder_dims_and_keys(tmp_path):
    model, _, _ = tiny("bert")
    model.save_pretrained(tmp_path)
    state, dims = hf_import.load_hf_encoder(str(tmp_path))
    assert dims == {"hidden": 32, "vocab": 120, "layers": 2, "heads": 4,
                    "intermediate": 64, "max_len": 48, "arch": "bert",
                    "pad_idx": 0}
    module = TransformerQuestionEncoder(vocab_size=120, hidden=32, layers=2,
                                        heads=4, intermediate=64, max_len=48)
    assert set(state) == set(module.state_dict())
    want = model.state_dict()["encoder.layer.1.attention.self.query.weight"]
    assert torch.equal(state["q_1.weight"], want)


def test_registry_name_resolves_through_the_hub_cache(tmp_path, monkeypatch):
    """``--lm sbert`` finds its checkpoint as try_to_load_from_cache does:
    ``models--<org>--<name>/snapshots/<refs/main>/`` under HF_HUB_CACHE."""
    model, _, _ = tiny("bert")
    repo = tmp_path / "models--sentence-transformers--all-MiniLM-L6-v2"
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("abc123")
    model.save_pretrained(repo / "snapshots" / "abc123")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    assert hf_import.resolve(hf_import.HF_MODEL_NAMES["sbert"]) == str(
        repo / "snapshots" / "abc123")
    lm = maybe_frozen_lm("sbert", word_dim=384, device="cpu")
    assert lm.weight_source == "hf:sbert" and lm.hidden == 32
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="not in the HF cache"):
        hf_import.resolve(hf_import.HF_MODEL_NAMES["sbert"])


def test_maybe_frozen_lm_falls_back_loudly(caplog):
    """A missing checkpoint degrades LOUDLY: a warning, and weight_source
    records the random init with the exception's type and text."""
    with caplog.at_level(logging.WARNING, logger="gnn_rag_tpu_torch"):
        lm = maybe_frozen_lm("/no/such/checkpoint-dir", word_dim=48, seed=3,
                             device="cpu")
    assert lm.weight_source.startswith("random-init(seed=3; FileNotFoundError: ")
    assert "/no/such/checkpoint-dir" in lm.weight_source
    assert any("RANDOM INIT" in r.message for r in caplog.records)
    assert type(lm.module) is TransformerQuestionEncoder and lm.hidden == 48


def test_cli_reads_the_checkpoint_and_decodes_questions(tmp_path):
    """The port's CLI on the micro dataset with a tiny bert and its
    BertTokenizer (built offline from a vocab file) installed as the sbert
    snapshot of a hub cache: the frozen LM is the checkpoint (its 32-wide
    states set the model's word_dim), the checkpoint metadata says so, and
    the `.info` questions are the decoded word pieces."""
    data = tmp_path / "data"
    data.mkdir()
    write_micro_dataset(data)
    questions = [json.loads(line)["question"] for split in ("train", "dev", "test")
                 for line in open(data / f"{split}.json")]
    words = sorted({w for q in questions for w in q.lower().split()})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    snap = (tmp_path / "hub" / "models--sentence-transformers--all-MiniLM-L6-v2"
            / "snapshots" / "abc123")
    snap.mkdir(parents=True)
    (snap.parent.parent / "refs").mkdir()
    (snap.parent.parent / "refs" / "main").write_text("abc123")
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    transformers.BertTokenizer(str(tmp_path / "vocab.txt")).save_pretrained(snap)
    model, _, _ = tiny("bert")
    model.save_pretrained(snap)
    flags = ["ReaRev", "--lm", "sbert", "--entity_dim", "16", "--num_iter", "2",
             "--num_ins", "2", "--num_gnn", "2", "--batch_size", "4",
             "--test_batch_size", "4", "--experiment_name", "tiny",
             "--data_folder", str(data) + "/", "--checkpoint_dir",
             str(tmp_path / "ckpt"), "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO, HF_HUB_CACHE=str(tmp_path / "hub"),
               HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    for extra in (["--num_epoch", "1", "--eval_every", "1"],
                  ["--is_eval", "--load_experiment", "tiny-final.ckpt"]):
        proc = subprocess.run([sys.executable, "-m", "gnn_rag_tpu_torch",
                               *flags, *extra], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
    meta = json.loads((tmp_path / "ckpt" / "tiny-final.ckpt.meta.json").read_text())
    assert meta["lm_weight_source"] == "hf:sbert"
    state = torch.load(tmp_path / "ckpt" / "tiny-final.ckpt", weights_only=True)
    assert state["question_emb.weight"].shape == (16, 32)
    info = [json.loads(line) for line in open(tmp_path / "ckpt" / "tiny_test.info")]
    tok = transformers.BertTokenizer.from_pretrained(snap)
    tests = [json.loads(line)["question"] for line in open(data / "test.json")]
    assert [r["question"] for r in info] == [
        "".join(w + " " for w in tok.tokenize(q)) for q in tests]
    assert info[0]["question"] != tests[0]
