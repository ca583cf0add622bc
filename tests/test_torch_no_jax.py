"""gnn_rag_tpu_torch runs without JAX: a fresh interpreter imports the port,
serves one question and trains one step on the CPU, and never loads jax,
flax, optax or orbax."""

import os
import subprocess
import sys

SCRIPT = r"""
import sys
import numpy as np
from gnn_rag_tpu.config import Config, DataConfig, ModelConfig
from gnn_rag_tpu_torch.data.vocab import Vocab
from gnn_rag_tpu_torch.models.rearev import build_model
from gnn_rag_tpu_torch.serve import RetrieverService

ents = {f"m.{i:02d}": i for i in range(20)}
rels = {"people.person.place_of_birth": 0, "location.location.contains": 1}
cfg = Config(data=DataConfig(name="webqsp"),
             model=ModelConfig(entity_dim=16, num_iter=2, num_ins=2, num_gnn=2))
rng = np.random.default_rng(0)
rel = [rng.standard_normal((4, 3, 24)).astype(np.float32) for _ in range(2)]
svc = RetrieverService(
    cfg, Vocab(ents, rels, {}), build_model(cfg, 20, 3, word_dim=24, seed=0),
    rel_hidden=rel[0], rel_hidden_inv=rel[1],
    rel_text_mask=np.ones((4, 3), np.float32),
    question_encoder=lambda ids: np.ones((len(ids), 24), np.float32))
q = {"id": "q0", "question": "where was m00 born", "entities": ["m.00"],
     "subgraph": {"entities": [f"m.{i:02d}" for i in range(6)],
                  "tuples": [["m.00", "people.person.place_of_birth", "m.01"],
                             ["m.01", "location.location.contains", "m.02"]]}}
out = svc.retrieve([q])
assert out[0]["cand"] and out[0]["paths"], out

import logging
from gnn_rag_tpu_torch.data.loader import KGQADataset, ingest_question
from gnn_rag_tpu_torch.train.trainer import Trainer
rec = ingest_question(dict(q, answers=["m.01"]), svc.vocab, data_name="webqsp",
                      use_inverse_relation=False, use_self_loop=True,
                      num_kb_relation=3)
rec.q_token_ids = np.zeros(4, np.int32)
ds = KGQADataset([rec], num_entity=20, num_kb_relation=3)
ds.q_hidden = [np.ones((4, 24), np.float32)]
tr = Trainer(cfg, train_data=ds, valid_data=ds, test_data=ds, num_entity=20,
             num_kb_relation=3, rel_hidden=rel[0], rel_hidden_inv=rel[1],
             rel_text_mask=np.ones((4, 3), np.float32), word_dim=24,
             logger=logging.getLogger("no_jax"))
loss, h1, f1 = tr.train_epoch()
tr.close()
assert tr.step_count == 1 and np.isfinite(loss), loss
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax"))
print("LOADED", loaded)
"""


def test_port_serves_without_jax():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]
