"""Configuration dataclasses for the GNN half (the port's own copy of
``gnn_rag_tpu.config``; tests/test_torch_copies.py holds the two equal).

Mirrors the flag surface of the reference CLI (reference: gnn/parsing.py:13-125)
but as typed configs. The reference threads a plain ``vars(args)`` dict through
every module; here each component takes the single frozen config object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset / vocabulary configuration (reference: parsing.py:14-31)."""

    name: str = "webqsp"                 # 'webqsp' | 'cwq' | 'metaqa' | ...
    data_folder: str = "data/webqsp/"
    max_train: int = 200_000
    word2id: str = "vocab.txt"
    relation2id: str = "relations.txt"
    entity2id: str = "entities.txt"
    entity_emb_file: Optional[str] = None
    relation_emb_file: Optional[str] = None
    word_emb_file: Optional[str] = "word_emb.npy"
    relation_word_emb: bool = True
    # tokenizer / LM used for questions and relation surface forms
    lm: str = "sbert"                    # 'lstm'|'bert'|'roberta'|'sbert'|'sbert2'|'simcse'|'t5'|'relbert'
    # Padding economics (new, TPU-specific): batches are padded to the
    # smallest (entity, fact) bucket that fits, so XLA compiles once per
    # bucket instead of once per batch (reference pads everything to the
    # dataset-global max: dataset_load.py:54,553).
    entity_buckets: Tuple[int, ...] = ()
    fact_buckets: Tuple[int, ...] = ()
    use_inverse_relation: bool = False
    use_self_loop: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Shared model hyper-parameters (reference: parsing.py:32-37, 85-125)."""

    model_name: str = "ReaRev"           # 'ReaRev' | 'NSM' | 'GraftNet'
    entity_dim: int = 50
    kg_dim: int = 100
    word_dim: int = 300                  # LSTM path; LM path overrides (384 for sbert)
    lm: str = "sbert"
    lm_frozen: bool = True
    lm_dropout: float = 0.3
    linear_dropout: float = 0.2
    loss_type: str = "kl"                # 'kl' | 'bce'
    label_smooth: float = 0.1
    eps: float = 0.95                    # candidate cumulative-prob threshold
    # ReaRev (parsing.py:85-98)
    alg: str = "bfs"
    num_iter: int = 2
    num_ins: int = 3
    num_gnn: int = 3
    pos_emb: bool = False
    # NSM (parsing.py:101-113)
    num_step: int = 3
    reason_kb: bool = False
    lambda_constrain: float = 0.0
    lambda_back: float = 0.0
    # GraftNet (parsing.py:115-125)
    num_layer: int = 3
    pagerank_lambda: float = 0.8
    fact_scale: int = 3
    # normalisation options
    norm_rel: bool = False
    normalized_gnn: bool = False
    use_self_loop: bool = True
    use_inverse_relation: bool = False
    fact_drop: float = 0.0               # applied on device during training
    # numerics: compute dtype for the GNN ('float32' or 'bfloat16')
    compute_dtype: str = "float32"

    # hyperparameters of the in-model trainable LM used when lm_frozen=0:
    # (vocab, hidden, layers, heads, intermediate, max_len, position_style,
    # pad_idx). None keeps the MiniLM-class defaults; the CLI fills this from
    # the loaded HF encoder so seed_submodule shapes always match.
    lm_spec: Optional[Tuple] = None

    @property
    def word_dim_effective(self) -> int:
        if self.lm == "lstm":
            return self.word_dim
        if self.lm_spec is not None:
            return self.lm_spec[1]
        return {"sbert": 384}.get(self.lm, 768)  # reference: bert_encoder.py:30-59


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation configuration (reference: parsing.py:39-64)."""

    num_epoch: int = 100
    warmup_epoch: int = 0
    eval_every: int = 2
    batch_size: int = 8
    test_batch_size: int = 20
    gradient_clip: float = 1.0
    lr: float = 5e-4
    decay_rate: float = 0.98             # ExponentialLR gamma (train_model.py:44-47)
    seed: int = 19960626
    fact_drop: float = 0.0
    checkpoint_dir: str = "checkpoint/pretrain/"
    experiment_name: str = "run"
    load_experiment: Optional[str] = None
    is_eval: bool = False
    # mesh / parallelism (new)
    dp_size: int = 1                     # data-parallel axis over questions
    tp_size: int = 1                     # tensor axis (relation/feature sharding)
    # observability (new): capture a jax.profiler device trace of one epoch
    profile_dir: Optional[str] = None
    # group shuffled batches by subgraph size to cut padding waste (new)
    bucket_batches: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
