"""Serve a trained retriever (and optionally the full QA loop) over HTTP, the
port of scripts/serve_qa.py.

One command takes the port's CLI flags (the JAX package's, plus ``--device
{cuda,cpu}``, default cuda) and a checkpoint, and stands up the service:

  python -m gnn_rag_tpu_torch.serve_qa ReaRev --data_folder data/synthqsp/ \\
      --checkpoint_dir checkpoints/synthqsp --load_experiment \\
      synthqsp-h1.ckpt --entity_dim 50 --num_iter 3 --num_ins 2 \\
      --num_gnn 3 --lm sbert --relation_word_emb True \\
      --port 8000 [--reader mock | --reader llama_tpu --reader_path DIR] \\
      [--keep_parallel] [--path_backend {auto,native,python,device}] \\
      [--device cpu]

POST /retrieve {"questions": [...]} -> candidates + verbalized paths
POST /answer   {"questions": [...]} -> LLM-read answers (with --reader)

Question schema = the reference JSONL: {question, entities,
subgraph: {entities, tuples}}. ``--reader llama_tpu`` is ``rag.llms.
LlamaTorch`` on ``--device`` (``--reader_quant int8`` weight-only int8,
``--reader_draft`` speculative decoding). ``--path_backend device`` runs the
shortest-path BFS of each request on ``--device``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    """The port's CLI parser with the serving flags on every model."""
    from .cli import build_parser as cli_parser

    parser = cli_parser()
    parser.prog = "python -m gnn_rag_tpu_torch.serve_qa"
    for sub in parser._subparsers._group_actions[0].choices.values():
        sub.add_argument("--port", type=int, default=8000)
        sub.add_argument("--host", default="localhost")
        sub.add_argument("--reader", default=None,
                         help="rag.llms registry name (mock, llama_tpu, ...)"
                              " — enables POST /answer")
        sub.add_argument("--reader_path", default=None)
        sub.add_argument("--reader_quant", default=None, choices=["int8"])
        sub.add_argument("--reader_draft", default=None,
                         help="draft bundle dir for speculative decoding")
        sub.add_argument("--reader_max_new_tokens", type=int, default=64)
        sub.add_argument("--keep_parallel", action="store_true")
        sub.add_argument("--path_backend", default="auto")
        sub.add_argument("--top_k_cand", type=int, default=10)
    return parser


def main(argv=None, block: bool = True):
    from .cli import assemble
    from .serve import QAService, RetrieverService

    args = build_parser().parse_args(argv)
    ctx = assemble(args=args)
    trainer, bundle, cfg, lm = (ctx["trainer"], ctx["bundle"], ctx["cfg"],
                                ctx["lm"])
    trainer.close()
    tokenizer = bundle["tokenizer"]
    pad = tokenizer.pad_id

    question_encoder = None
    if lm is not None and cfg.model.lm != "lstm" and cfg.model.lm_frozen:
        def question_encoder(ids):
            row = np.pad(ids, (0, max(0, 64 - len(ids))))[:64]
            return lm.encode(row[None], pad_id=pad)[0, : len(ids)]

    # the trained model and its frozen inputs (rel_args: the relation
    # states, then the entity, word and relation tables)
    svc = RetrieverService(
        cfg, bundle["vocab"], trainer.model,
        **dict(zip(("rel_hidden", "rel_hidden_inv", "rel_text_mask",
                    "entity_emb", "word_emb", "relation_emb"),
                   (None if a is None else a.cpu().numpy()
                    for a in trainer.rel_args))),
        tokenizer=tokenizer, question_encoder=question_encoder,
        path_backend=args.path_backend, keep_parallel=args.keep_parallel)

    if args.reader:
        from .rag.llms import get_registed_model

        reader_args = argparse.Namespace(
            model_path=args.reader_path, quant=args.reader_quant,
            draft_path=args.reader_draft, spec_gamma=4,
            max_new_tokens=args.reader_max_new_tokens, device=args.device)
        reader = get_registed_model(args.reader)(reader_args)
        reader.prepare_for_inference()
        service = QAService(svc, reader, top_k_cand=args.top_k_cand)
        log(f"QAService ready: /answer + /retrieve (reader={args.reader})")
    else:
        service = svc
        log("RetrieverService ready: /retrieve")

    httpd = service.serve_http(host=args.host, port=args.port)
    # handles for programmatic drivers
    httpd.service = service
    httpd.retriever = svc
    log(f"listening on http://{args.host}:{httpd.server_port}")
    if not block:
        return httpd
    try:
        import threading
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()


if __name__ == "__main__":
    main()
