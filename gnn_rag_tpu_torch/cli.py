"""Train / evaluate CLI of the port, with the JAX package's flags.

    python -m gnn_rag_tpu_torch ReaRev --data_folder data/webqsp/ \
        --lm sbert --relation_word_emb True --entity_dim 50 --num_iter 3 \
        --num_ins 2 --num_gnn 3 --batch_size 8 --linear_dropout 0.2 \
        --lr 5e-4 --gradient_clip 1.0 --experiment_name webqsp_rearev

The parser is ``gnn_rag_tpu.cli.build_parser`` (framework-free; the flag
names of the reference's gnn/parsing.py) plus ``--device {cuda,cpu}``
(default cuda; asking for cuda without a card raises, there is no silent CPU
run). ``assemble`` loads the data, runs the frozen LM once over relation
texts and questions and builds the Trainer; ``run`` trains, or with
``--is_eval`` writes the test `.info` (port of gnn_rag_tpu/cli.py:171-319).
Flags outside the ported configuration raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os

import torch

from gnn_rag_tpu.cli import args_to_config
from gnn_rag_tpu.cli import build_parser as _reference_parser
from gnn_rag_tpu.utils.logging import create_logger

from .data.loader import load_dataset_dir
from .models.frozen_lm import FrozenLM, encode_questions, encode_relations
from .models.rearev import check_supported as check_model_supported
from .train.trainer import Trainer


def build_parser() -> argparse.ArgumentParser:
    parser = _reference_parser()
    parser.prog = "python -m gnn_rag_tpu_torch"
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for sub in action.choices.values():
                sub.add_argument("--device", default="cuda",
                                 choices=["cuda", "cpu"])
    return parser


def check_supported(cfg, args) -> None:
    """Raise ``NotImplementedError`` for flags outside the ported
    configuration."""
    check_model_supported(cfg.model)
    d = cfg.data
    unported = {
        "relation_word_emb False": not d.relation_word_emb,
        "entity_emb_file": bool(d.entity_emb_file) and os.path.exists(
            os.path.join(d.data_folder, d.entity_emb_file)),
        "relation_emb_file": bool(d.relation_emb_file),
        "num_workers > 0": args.num_workers > 0,
        "info_attention": args.info_attention,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"gnn_rag_tpu_torch CLI: not ported: "
                                  f"{', '.join(bad)}")


def device_of(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is false "
                           "(pass --device cpu to run on the CPU)")
    return torch.device(name)


def assemble(argv=None) -> dict:
    """Parse flags, load data, encode relation texts and questions with the
    frozen LM, and build the Trainer (restoring --load_experiment). Returns
    {trainer, bundle, cfg, args, lm}."""
    args = build_parser().parse_args(argv)
    device = device_of(args.device)
    cfg = args_to_config(args)
    check_supported(cfg, args)
    logger = create_logger("gnn_rag_tpu_torch", cfg.train.checkpoint_dir,
                           config=cfg.model)
    bundle = load_dataset_dir(cfg)
    pad = bundle["tokenizer"].pad_id
    word_dim = cfg.model.word_dim_effective
    lm = FrozenLM(word_dim=word_dim, seed=cfg.train.seed, device=device)
    logger.info("frozen LM %s: %s (no pretrained weights are read)",
                cfg.model.lm, lm.weight_source)
    rel_hidden, rel_hidden_inv, rel_mask = encode_relations(
        lm, bundle["rel_tokens"], bundle["rel_tokens_inv"], pad)
    for split in ("train", "valid", "test"):
        if bundle[split] is not None:
            encode_questions(lm, bundle[split], pad)
    vocab = bundle["vocab"]
    trainer = Trainer(
        cfg, train_data=bundle["train"], valid_data=bundle["valid"],
        test_data=bundle["test"], num_entity=vocab.num_entity,
        num_kb_relation=bundle["num_kb_relation"], rel_hidden=rel_hidden,
        rel_hidden_inv=rel_hidden_inv, rel_text_mask=rel_mask,
        word_dim=word_dim, id2entity=vocab.id2entity, logger=logger,
        lm_source=lm.weight_source, device=device)
    if cfg.train.load_experiment:
        trainer.load_ckpt(os.path.join(cfg.train.checkpoint_dir,
                                       cfg.train.load_experiment))
    return {"trainer": trainer, "bundle": bundle, "cfg": cfg, "args": args,
            "lm": lm}


def run(argv=None) -> dict:
    """Train (or, with --is_eval, evaluate and export `.info`); returns the
    context of ``assemble`` with ``history``, each epoch's (loss, h1, f1)."""
    ctx = assemble(argv)
    trainer, cfg = ctx["trainer"], ctx["cfg"]
    ctx["history"] = []
    try:
        if cfg.train.is_eval:
            trainer.evaluate_single()
        else:
            ctx["history"] = trainer.train(0, cfg.train.num_epoch - 1)
    finally:
        trainer.close()
    return ctx
