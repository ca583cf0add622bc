"""Train / evaluate CLI of the port, with the JAX package's flags.

    python -m gnn_rag_tpu_torch ReaRev --data_folder data/webqsp/ \
        --lm sbert --relation_word_emb True --entity_dim 50 --num_iter 3 \
        --num_ins 2 --num_gnn 3 --batch_size 8 --linear_dropout 0.2 \
        --lr 5e-4 --gradient_clip 1.0 --experiment_name webqsp_rearev

The flags are those of the JAX package's CLI (``build_parser`` and
``args_to_config`` are copies of gnn_rag_tpu/cli.py:21-168; the flag names of
the reference's gnn/parsing.py) plus ``--device {cuda,cpu}`` (default cuda;
asking for cuda without a card raises, there is no silent CPU run). ``assemble`` loads the data, runs the frozen LM once over relation
texts and questions and builds the Trainer; ``run`` trains, or with
``--is_eval`` writes the test `.info` (port of gnn_rag_tpu/cli.py:171-319),
with ``--info_attention`` the instruction attention in its per-iteration
slots. The three retrievers (``ReaRev``, ``NSM``, ``GraftNet``) take every
option the JAX package takes.

The frozen LM loads a local HF checkpoint for ``--lm`` when there is one
(``models.frozen_lm.maybe_frozen_lm``) and falls back loudly to a random
encoder otherwise. As in JAX, it runs only with relation texts on: it
encodes them, and with a frozen transformer ``--lm`` the questions too; with
``--lm lstm`` the relation texts still go through it (the random-init
fallback at ``word_dim``, as the JAX CLI does), the questions through the
model's LSTM; with ``--lm_frozen 0`` the model's own transformer is pinned to
its widths and seeded from its weights (``Trainer.seed_submodule``). The
``--entity_emb_file`` and ``--word_emb_file`` tables (the latter with
``--lm lstm`` only) load padded with one zero row, ``--relation_emb_file``
through ``data.loader.load_relation_emb``; each is skipped when its file is
missing.

With ``--dp_size * --tp_size > 1`` the CLI runs as one rank of a
``torchrun`` launch (gnn_rag_tpu/cli.py:281-285): it builds the mesh from
the launcher's environment (``parallel.mesh.make_mesh``: NCCL, one card a
rank, on ``--device cuda``; gloo on ``--device cpu``) and hands it to the
Trainer, and rank 0 writes the log file, checkpoints and `.info`:

    torchrun --nproc_per_node=4 -m gnn_rag_tpu_torch ReaRev ... \
        --dp_size 2 --tp_size 2

``--profile_dir DIR`` writes a ``torch.profiler`` trace of the first epoch
into DIR.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .config import Config, DataConfig, ModelConfig, TrainConfig
from .data.loader import load_dataset_dir, load_relation_emb
from .models.frozen_lm import encode_questions, encode_relations, maybe_frozen_lm
from .models.encoders import TransformerQuestionEncoder
from .models.retriever import check_supported
from .train.trainer import Trainer
from .utils.logging import create_logger


def bool_flag(v: str) -> bool:
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def add_shared_args(parser):
    parser.add_argument("--name", default="webqsp", type=str)
    parser.add_argument("--data_folder", default="data/webqsp/", type=str)
    parser.add_argument("--max_train", default=200000, type=int)
    parser.add_argument("--word2id", default="vocab.txt", type=str)
    parser.add_argument("--relation2id", default="relations.txt", type=str)
    parser.add_argument("--entity2id", default="entities.txt", type=str)
    parser.add_argument("--entity_emb_file", default=None, type=str)
    parser.add_argument("--relation_emb_file", default=None, type=str)
    parser.add_argument("--relation_word_emb", default=True, type=bool_flag)
    parser.add_argument("--word_emb_file", default="word_emb.npy", type=str)
    parser.add_argument("--lm", default="lstm", type=str,
                        choices=["lstm", "bert", "roberta", "sbert", "t5",
                                 "sbert2", "simcse", "relbert"])
    parser.add_argument("--lm_frozen", default=1, type=int)
    parser.add_argument("--entity_dim", default=50, type=int)
    parser.add_argument("--kg_dim", default=100, type=int)
    parser.add_argument("--word_dim", default=300, type=int)
    parser.add_argument("--lm_dropout", default=0.3, type=float)
    parser.add_argument("--linear_dropout", default=0.2, type=float)
    parser.add_argument("--num_epoch", default=100, type=int)
    parser.add_argument("--warmup_epoch", default=0, type=int)
    parser.add_argument("--fact_scale", default=3, type=int)
    parser.add_argument("--eval_every", default=2, type=int)
    parser.add_argument("--batch_size", default=20, type=int)
    parser.add_argument("--gradient_clip", default=1.0, type=float)
    parser.add_argument("--lr", default=0.0005, type=float)
    parser.add_argument("--decay_rate", default=0.0, type=float)
    parser.add_argument("--seed", default=19960626, type=int)
    parser.add_argument("--label_smooth", default=0.1, type=float)
    parser.add_argument("--fact_drop", default=0, type=float)
    parser.add_argument("--is_eval", action="store_true")
    parser.add_argument("--checkpoint_dir", default="checkpoint/pretrain/", type=str)
    parser.add_argument("--experiment_name", default="", type=str)
    parser.add_argument("--load_experiment", default=None, type=str)
    parser.add_argument("--load_ckpt_file", default=None, type=str)
    parser.add_argument("--eps", default=0.95, type=float)
    parser.add_argument("--test_batch_size", default=20, type=int)
    parser.add_argument("--q_type", default="seq", type=str)
    # TPU-specific (new)
    parser.add_argument("--dp_size", default=1, type=int)
    parser.add_argument("--tp_size", default=1, type=int)
    parser.add_argument("--compute_dtype", default="float32", type=str)
    parser.add_argument("--profile_dir", default=None, type=str)
    parser.add_argument("--num_workers", default=0, type=int,
                        help="multiprocess JSONL ingest workers")
    parser.add_argument("--bucket_batches", default=False, type=bool_flag,
                        help="group shuffled batches by similar fact count "
                             "(cuts padding waste on skewed datasets like CWQ)")
    parser.add_argument("--info_attention", action="store_true",
                        help="fill the .info per-iteration slots with "
                             "instruction attention over question tokens "
                             "(opt-in; the shipped artifact has them empty)")
    # the port's own flag: cuda (the default) raises without a card
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("python -m gnn_rag_tpu_torch")
    sub = parser.add_subparsers(dest="model_name", required=True)

    p = sub.add_parser("ReaRev")
    p.add_argument("--alg", default="bfs", type=str)
    p.add_argument("--num_iter", default=2, type=int)
    p.add_argument("--num_ins", default=3, type=int)
    p.add_argument("--num_gnn", default=3, type=int)
    p.add_argument("--loss_type", default="kl", type=str)
    p.add_argument("--use_self_loop", default=True, type=bool_flag)
    p.add_argument("--normalized_gnn", default=False, type=bool_flag)
    p.add_argument("--norm_rel", action="store_true")
    p.add_argument("--pos_emb", action="store_true")
    add_shared_args(p)

    p = sub.add_parser("NSM")
    p.add_argument("--num_step", default=3, type=int)
    p.add_argument("--reason_kb", default=False, type=bool_flag)
    p.add_argument("--loss_type", default="kl", type=str)
    p.add_argument("--lambda_constrain", default=0.0, type=float)
    p.add_argument("--lambda_back", default=0.0, type=float)
    p.add_argument("--use_self_loop", default=True, type=bool_flag)
    p.add_argument("--use_inverse_relation", action="store_true")
    p.add_argument("--norm_rel", action="store_true")
    p.add_argument("--normalized_gnn", default=False, type=bool_flag)
    add_shared_args(p)

    p = sub.add_parser("GraftNet")
    p.add_argument("--pagerank_lambda", default=0.8, type=float)
    p.add_argument("--loss_type", default="bce", type=str)
    p.add_argument("--num_layer", default=3, type=int)
    p.add_argument("--use_inverse_relation", action="store_true")
    p.add_argument("--norm_rel", action="store_true")
    p.add_argument("--normalized_gnn", default=False, type=bool_flag)
    add_shared_args(p)

    return parser


def args_to_config(args: argparse.Namespace) -> Config:
    a = vars(args)
    get = a.get
    data = DataConfig(
        name=a["name"], data_folder=a["data_folder"], max_train=a["max_train"],
        word2id=a["word2id"], relation2id=a["relation2id"],
        entity2id=a["entity2id"], entity_emb_file=a["entity_emb_file"],
        relation_emb_file=a["relation_emb_file"],
        word_emb_file=a["word_emb_file"],
        relation_word_emb=a["relation_word_emb"], lm=a["lm"],
        use_inverse_relation=get("use_inverse_relation", False),
        use_self_loop=get("use_self_loop", True))
    model = ModelConfig(
        model_name=a["model_name"], entity_dim=a["entity_dim"],
        kg_dim=a["kg_dim"], word_dim=a["word_dim"], lm=a["lm"],
        lm_frozen=bool(a["lm_frozen"]), lm_dropout=a["lm_dropout"],
        linear_dropout=a["linear_dropout"], loss_type=get("loss_type", "kl"),
        label_smooth=a["label_smooth"], eps=a["eps"],
        alg=get("alg", "bfs"), num_iter=get("num_iter", 2),
        num_ins=get("num_ins", 3), num_gnn=get("num_gnn", 3),
        pos_emb=get("pos_emb", False), num_step=get("num_step", 3),
        reason_kb=get("reason_kb", False),
        lambda_constrain=get("lambda_constrain", 0.0),
        lambda_back=get("lambda_back", 0.0),
        num_layer=get("num_layer", 3),
        pagerank_lambda=get("pagerank_lambda", 0.8),
        fact_scale=a["fact_scale"], norm_rel=get("norm_rel", False),
        normalized_gnn=get("normalized_gnn", False),
        use_self_loop=get("use_self_loop", True),
        use_inverse_relation=get("use_inverse_relation", False),
        fact_drop=a["fact_drop"], compute_dtype=a["compute_dtype"])
    experiment_name = a["experiment_name"] or "{}-{}".format(
        a["name"], time.strftime("%Y%m%d-%H%M%S"))
    train = TrainConfig(
        num_epoch=a["num_epoch"], warmup_epoch=a["warmup_epoch"],
        eval_every=a["eval_every"], batch_size=a["batch_size"],
        test_batch_size=a["test_batch_size"],
        gradient_clip=a["gradient_clip"], lr=a["lr"],
        decay_rate=a["decay_rate"], seed=a["seed"], fact_drop=a["fact_drop"],
        checkpoint_dir=a["checkpoint_dir"], experiment_name=experiment_name,
        load_experiment=a["load_experiment"], is_eval=a["is_eval"],
        dp_size=a["dp_size"], tp_size=a["tp_size"],
        profile_dir=a["profile_dir"],
        bucket_batches=get("bucket_batches", False))
    return Config(data=data, model=model, train=train)


def device_of(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is false "
                           "(pass --device cpu to run on the CPU)")
    return torch.device(name)


def question_decoder(tok):
    """The `.info` question text of the JAX CLI (gnn_rag_tpu/cli.py:265-279;
    the reference's evaluate.py:143-156 writes the DECODED token sequence,
    not the raw question): an HF tokenizer's word pieces without [CLS],
    [SEP] and [PAD], or an LSTM tokenizer's words, each followed by a
    space. None for other tokenizers (the raw question is written)."""
    if hasattr(tok, "tok"):  # HFTokenizer
        def decode(ids):
            words = tok.tok.convert_ids_to_tokens([int(i) for i in ids])
            return "".join(w + " " for w in words
                           if w not in ("[CLS]", "[SEP]", "[PAD]"))
        return decode
    if hasattr(tok, "word2id"):  # LSTMWordTokenizer
        id2word = {i: w for w, i in tok.word2id.items()}
        return lambda ids: "".join(id2word[int(i)] + " " for i in ids
                                   if int(i) in id2word)
    return None


def load_padded(folder: str, fname):
    """A frozen embedding table padded with one zero row
    (base_model.py:79-114), or None when no file is named or it is missing."""
    if not fname:
        return None
    path = os.path.join(folder, fname)
    if not os.path.exists(path):
        return None
    return np.pad(np.load(path), ((0, 1), (0, 0))).astype(np.float32)


def assemble(argv=None, args=None) -> dict:
    """Parse flags (or take the parsed ``args``), load data, encode relation
    texts (and questions) with the frozen LM, load the frozen tables, and
    build the Trainer (seeding the in-model LM for ``--lm_frozen 0``,
    restoring --load_experiment). Returns {trainer, bundle, cfg, args, lm,
    rel_hidden, rel_hidden_inv, rel_mask}; ``lm`` and the relation states
    are None with relation texts off."""
    if args is None:
        args = build_parser().parse_args(argv)
    device = device_of(args.device)
    cfg = args_to_config(args)
    check_supported(cfg.model)
    from .parallel.mesh import local_mesh, make_mesh
    mesh = (make_mesh(dp=cfg.train.dp_size, tp=cfg.train.tp_size, device=device)
            if cfg.train.dp_size * cfg.train.tp_size > 1 else local_mesh(device))
    device = mesh.device
    logger = create_logger("gnn_rag_tpu_torch",
                           cfg.train.checkpoint_dir if mesh.rank == 0 else None,
                           config=cfg.model)
    if mesh.size > 1:
        logger.info("mesh: dp=%d tp=%d", cfg.train.dp_size, cfg.train.tp_size)
    bundle = load_dataset_dir(cfg, num_workers=args.num_workers)
    pad = bundle["tokenizer"].pad_id
    mc = cfg.model
    rel_hidden = rel_hidden_inv = rel_mask = lm = None
    if cfg.data.relation_word_emb and bundle["rel_tokens"] is not None:
        lm = maybe_frozen_lm(mc.lm, mc.word_dim_effective, seed=cfg.train.seed,
                             logger=logger, device=device)
        logger.info("frozen LM %s: %s", mc.lm, lm.weight_source)
        if mc.lm != "lstm" and not mc.lm_frozen:
            # the in-model encoder must match the loaded one exactly, or
            # seed_submodule cannot overlay it: pin its widths from it
            m = lm.module
            if not isinstance(m, TransformerQuestionEncoder):
                raise SystemExit(f"--lm_frozen 0 only supports bert-family "
                                 f"encoders; {mc.lm!r} loaded a "
                                 f"{type(m).__name__}")
            mc = dataclasses.replace(mc, lm_spec=(
                m.vocab_size, m.hidden, m.layers, m.heads, m.intermediate,
                m.max_len, m.position_style, m.pad_idx))
            cfg = dataclasses.replace(cfg, model=mc)
        rel_hidden, rel_hidden_inv, rel_mask = encode_relations(
            lm, bundle["rel_tokens"], bundle["rel_tokens_inv"], pad)
        if mc.lm != "lstm" and mc.lm_frozen:
            # questions encoded once here; with --lm_frozen 0 the in-model
            # encoder runs inside the step and trains
            for split in ("train", "valid", "test"):
                if bundle[split] is not None:
                    encode_questions(lm, bundle[split], pad)

    folder = cfg.data.data_folder
    entity_emb = load_padded(folder, cfg.data.entity_emb_file)
    word_emb = (load_padded(folder, cfg.data.word_emb_file)
                if mc.lm == "lstm" else None)
    # the frozen KG relation table (base_model.py:122-134, 153-162): the
    # models read it only with relation texts off, as in the reference
    relation_emb = None
    if cfg.data.relation_emb_file:
        relation_emb = load_relation_emb(
            os.path.join(folder, cfg.data.relation_emb_file),
            bundle["num_kb_relation"], cfg.data.use_inverse_relation,
            cfg.data.use_self_loop)
        if relation_emb is None:
            logger.info("relation_emb_file missing or its rows do not match: "
                        "random init (base_model.py:127-128)")
    vocab = bundle["vocab"]
    trainer = Trainer(
        cfg, train_data=bundle["train"], valid_data=bundle["valid"],
        test_data=bundle["test"], num_entity=vocab.num_entity,
        num_kb_relation=bundle["num_kb_relation"], rel_hidden=rel_hidden,
        rel_hidden_inv=rel_hidden_inv, rel_text_mask=rel_mask,
        num_word=len(vocab.word2id), entity_emb=entity_emb, word_emb=word_emb,
        relation_emb=relation_emb, id2entity=vocab.id2entity, logger=logger,
        lm_source=lm.weight_source if lm is not None else None,
        decode_question=question_decoder(bundle["tokenizer"]), device=device,
        mesh=mesh)
    if mc.lm != "lstm" and not mc.lm_frozen and rel_hidden is not None:
        # the trainable in-model LM starts from the frozen path's weights
        # (HF or the seeded random init) and finetunes (bert_encoder.py:80-83)
        trainer.seed_submodule("lm", lm.module.state_dict())
    if cfg.train.load_experiment:
        trainer.load_ckpt(os.path.join(cfg.train.checkpoint_dir,
                                       cfg.train.load_experiment))
    return {"trainer": trainer, "bundle": bundle, "cfg": cfg, "args": args,
            "lm": lm, "rel_hidden": rel_hidden,
            "rel_hidden_inv": rel_hidden_inv, "rel_mask": rel_mask}


def run(argv=None) -> dict:
    """Train (or, with --is_eval, evaluate and export `.info`); returns the
    context of ``assemble`` with ``history``, each epoch's (loss, h1, f1)."""
    ctx = assemble(argv)
    trainer, cfg = ctx["trainer"], ctx["cfg"]
    ctx["history"] = []
    try:
        if cfg.train.is_eval:
            trainer.evaluate_single(write_attention=ctx["args"].info_attention)
        else:
            ctx["history"] = trainer.train(0, cfg.train.num_epoch - 1)
    finally:
        trainer.close()
    return ctx
