"""The port's Evaluator and `.info` export against the JAX package's, on the
micro dataset loaded by both packages: after ``train_epoch``'s kind of
shuffle (``reset_batches(is_sequential=False, rng)``) the Evaluator restores
sequential order, so the `.info` lines come in the split's order, line for
line the JAX Evaluator's on the same predictions; ``decode_question`` gives
the `.info` question (the CLI's decoders: an HF tokenizer's word pieces, with
a ``BertTokenizer`` built offline from a vocab file, or an LSTM tokenizer's
words)."""

import json

import numpy as np
import pytest
import torch
from test_cli_e2e import write_micro_dataset

from gnn_rag_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from gnn_rag_tpu.data.loader import load_dataset_dir as jax_load_dataset_dir
from gnn_rag_tpu.train.evaluate import Evaluator as JEvaluator
from gnn_rag_tpu_torch.cli import question_decoder
from gnn_rag_tpu_torch.data.loader import load_dataset_dir
from gnn_rag_tpu_torch.data.tokenizers import HFTokenizer, LSTMWordTokenizer
from gnn_rag_tpu_torch.train.evaluate import Evaluator


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    root = tmp_path_factory.mktemp("micro_eval")
    write_micro_dataset(root)
    cfg = Config(data=DataConfig(name="webqsp", data_folder=str(root) + "/"),
                 model=ModelConfig(entity_dim=16, num_iter=2),
                 train=TrainConfig(checkpoint_dir=str(root / "ckpt")))
    return root, jax_load_dataset_dir(cfg), load_dataset_dir(cfg)


def dist_of(batch, num_entity):
    """A prediction made from the batch alone (seeded by its entity ids),
    so each question's candidates depend on which question it is."""
    gids = np.asarray(batch.entity_gids)
    score = np.where(gids < num_entity, (gids * 7919 % 13) + 1.0, 0.0)
    return (score / score.sum(1, keepdims=True)).astype(np.float32)


def run_both(micro, tmp_path, decode=None):
    root, jb, tb = micro
    num_entity = tb["vocab"].num_entity
    kw = dict(eps=0.95, num_entity=num_entity, id2entity=tb["vocab"].id2entity,
              num_iter=2)
    jds, tds = jb["train"], tb["train"]
    for ds in (jds, tds):          # the order an epoch of training leaves
        ds.reset_batches(is_sequential=False, rng=np.random.default_rng(5))
    assert list(tds.batch_indices(0, 8)) != list(range(8))
    paths = tmp_path / "jax.info", tmp_path / "port.info"
    JEvaluator(**kw).evaluate(
        jds, lambda b: (0.0, None, dist_of(b, num_entity)), test_batch_size=3,
        write_info=True, info_path=str(paths[0]), decode_question=decode)
    Evaluator(**kw).evaluate(
        tds, lambda b: (torch.tensor(0.0), None,
                        torch.from_numpy(dist_of(b, num_entity))),
        test_batch_size=3, write_info=True, info_path=str(paths[1]),
        decode_question=decode)
    return [[json.loads(line) for line in open(p)] for p in paths], tds


def test_info_order_after_a_shuffle_matches_jax(micro, tmp_path):
    (want, got), tds = run_both(micro, tmp_path)
    assert len(got) == tds.num_data == 8
    assert got == want
    assert [r["question"] for r in got] == [r.question for r in tds.records]


def test_info_question_is_decoded(micro, tmp_path):
    transformers = pytest.importorskip("transformers")
    root, _, tb = micro
    words = sorted({w for r in tb["train"].records for w in r.question.split()})
    (tmp_path / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + words) + "\n")
    hf = HFTokenizer.__new__(HFTokenizer)
    hf.tok = transformers.BertTokenizer(str(tmp_path / "vocab.txt"))
    decode = question_decoder(hf)
    _, jb, _ = micro
    for ds in (jb["train"], tb["train"]):   # the ids the loader's HF path makes
        for r in ds.records:
            r.q_token_ids = np.asarray(hf.tok(
                r.question, max_length=16, padding="max_length")["input_ids"],
                np.int32)
    (want, got), tds = run_both(micro, tmp_path, decode)
    assert got == want
    ids = hf.tok(tds.records[0].question, max_length=12, padding="max_length")
    assert decode(ids["input_ids"]) == "".join(
        w + " " for w in hf.tok.tokenize(tds.records[0].question))
    assert [r["question"] for r in got] == [decode(r.q_token_ids)
                                            for r in tds.records]


def test_lstm_question_decoder():
    decode = question_decoder(LSTMWordTokenizer({"who": 0, "is": 1, "born": 2}))
    assert decode(np.array([0, 2, 3, 3])) == "who born "
    assert question_decoder(object()) is None
