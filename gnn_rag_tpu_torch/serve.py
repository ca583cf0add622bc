"""RetrieverService: serving the GNN retrieval stage on a CUDA device.

Port of ``gnn_rag_tpu.serve.RetrieverService``:

    question + subgraph  ->  GraphBatch (kernel layout)  ->  frozen-LM
    question states  ->  retriever forward  ->  eps-cumulative candidates
    ->  shortest paths  ->  verbalized reasoning paths (ready for any reader)

The retriever is whatever model the checkpoint holds (ReaRev, NSM or
GraftNet): given a state_dict, the service builds the model through the
trainer's ``build_model`` as the JAX service does
(gnn_rag_tpu/serve.py:45); given a built model, it serves that.

Path enumeration has three backends, as in JAX: ``native`` (the C++
enumerator, when it builds) and ``python`` (the oracle) run on the host,
through the port's copies of ``native`` and ``rag.graph_utils``;
``device`` computes the BFS levels of a whole request on the model's device
(``rag.path_extract.BatchedPathExtractor``, bounded by ``max_hops`` when
given) and walks the paths on the host. ``auto`` never picks ``device``.
``serve_http`` exposes ``POST /retrieve``.

``QAService`` (port of ``gnn_rag_tpu.serve.QAService``) puts a reader of the
``rag.llms`` registry behind the retriever: question + subgraph in, the
read answer out, with the offline path's ``PromptBuilder``; its
``serve_http`` exposes ``POST /answer`` beside ``POST /retrieve``.

Each stage of ``retrieve`` runs in a ``torch.profiler.record_function``
span named ``retrieve/<stage>`` (ingest, encode_question, make_batch,
forward, candidates, paths, verbalize); ``forward`` ends with the copy of
``pred_dist`` to the host, so it holds the device time. The spans cost a
few microseconds each when no profiler is running.
"""

from __future__ import annotations

import json
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from .config import Config
from .data.loader import KGQADataset, ingest_question, num_kb_relation
from .data.vocab import Vocab
from .rag.graph_utils import build_graph, get_truth_paths, get_truth_paths_fast
from .rag.text_utils import path_to_string
from .train.metrics import extract_candidates, f1_and_hits_eval


class RetrieverService:
    def __init__(self, cfg: Config, vocab: Vocab, model, *,
                 rel_hidden: Optional[np.ndarray] = None,
                 rel_hidden_inv: Optional[np.ndarray] = None,
                 rel_text_mask: Optional[np.ndarray] = None,
                 entity_emb: Optional[np.ndarray] = None,
                 word_emb: Optional[np.ndarray] = None,
                 relation_emb: Optional[np.ndarray] = None,
                 question_encoder: Optional[Callable] = None,
                 tokenizer=None, max_hops: Optional[int] = None,
                 entity_buckets=(256, 512, 1024, 2048),
                 fact_buckets=(1024, 2048, 4096, 8192, 16384),
                 path_backend: str = "auto", keep_parallel: bool = False,
                 device="cuda"):
        """model: a retriever on its device (``train.trainer.build_model``),
        or a state_dict of one (a checkpoint), built here on ``device`` for
        ``cfg.model.model_name`` and the frozen inputs given;
        question_encoder(token_ids) -> [L, word_dim] frozen-LM states (None:
        the questions go to the model as tokens, to its LSTM or in-model
        LM); the frozen relation states and tables as the Trainer takes
        them (None where not used); ``max_hops`` bounds the ``device``
        path backend's BFS (None: to the graph's diameter)."""
        self.cfg = cfg
        self.vocab = vocab
        self.nkr = num_kb_relation(vocab.num_relation,
                                   cfg.data.use_inverse_relation,
                                   cfg.data.use_self_loop)
        if not isinstance(model, torch.nn.Module):
            from .train.trainer import build_model, model_inputs
            state = model
            model = build_model(cfg, vocab.num_entity, self.nkr, device=device,
                                **model_inputs(
                                    cfg, q_hidden=question_encoder is not None,
                                    rel_hidden=rel_hidden, entity_emb=entity_emb,
                                    word_emb=word_emb, relation_emb=relation_emb,
                                    word_dim=cfg.model.word_dim_effective,
                                    num_word=len(vocab.word2id)))
            model.load_state_dict(state)
        self.model = model
        self.device = next(model.parameters()).device
        self.rel_args = tuple(
            None if a is None else torch.as_tensor(np.asarray(a, np.float32),
                                                   device=self.device)
            for a in (rel_hidden, rel_hidden_inv, rel_text_mask, entity_emb,
                      word_emb, relation_emb))
        self.question_encoder = question_encoder
        self.tokenizer = tokenizer
        # 'auto' picks the C++ enumerator, else the Python oracle; the
        # device BFS is taken only when asked for, and keeps collapse
        # semantics, so keep_parallel sends it to the host backends too
        # (gnn_rag_tpu/serve.py:50-67)
        from .native import available as native_available
        if path_backend == "auto" or (keep_parallel and path_backend == "device"):
            path_backend = "native" if native_available() else "python"
        if path_backend not in ("native", "python", "device"):
            raise ValueError(f"unknown path backend {path_backend!r}")
        self.path_backend = path_backend
        self.keep_parallel = keep_parallel
        self.max_hops = max_hops
        self.extractor = None
        if path_backend == "device":
            from .rag.path_extract import BatchedPathExtractor
            self.extractor = BatchedPathExtractor(max_hops=max_hops,
                                                  device=self.device)
        self.entity_buckets = entity_buckets
        self.fact_buckets = fact_buckets

    def forward(self, batch):
        """(loss, pred, pred_dist) of a numpy GraphBatch on the device."""
        return self.model(batch.to(self.device), *self.rel_args)

    # ------------------------------------------------------------------
    def retrieve(self, questions: Sequence[dict], *,
                 with_paths: bool = True) -> List[dict]:
        """questions: reference JSONL schema (question, entities,
        subgraph{entities, tuples}); returns per-question candidates
        [[mid, prob]...] and verbalized reasoning paths."""
        with record_function("retrieve/ingest"):
            records = [ingest_question(
                q, self.vocab, data_name=self.cfg.data.name,
                use_inverse_relation=self.cfg.data.use_inverse_relation,
                use_self_loop=self.cfg.data.use_self_loop,
                num_kb_relation=self.nkr) for q in questions]
            ds = KGQADataset([r for r in records if r is not None],
                             num_entity=self.vocab.num_entity,
                             num_kb_relation=self.nkr,
                             entity_buckets=self.entity_buckets,
                             fact_buckets=self.fact_buckets)
        results = []
        if len(ds):
            with record_function("retrieve/encode_question"):
                if self.tokenizer is not None:
                    ds.tokenize_questions(self.tokenizer)
                else:
                    for r in ds.records:
                        r.q_token_ids = np.zeros(4, np.int32)
                if self.question_encoder is not None:
                    ds.q_hidden = [self.question_encoder(r.q_token_ids)
                                   for r in ds.records]
            with record_function("retrieve/make_batch"):
                batch = ds.make_batch(list(range(len(ds))))
            with record_function("retrieve/forward"), torch.inference_mode():
                _, _, pred_dist = self.forward(batch)
                pred_dist = pred_dist.float().cpu().numpy()
            ignore_prob = (1 - self.cfg.model.eps) / ds.max_local_entity

        with record_function("retrieve/candidates"):
            ri = 0
            for rec in records:
                if rec is None:
                    results.append({"cand": [], "paths": []})
                    continue
                cand2prob = extract_candidates(
                    pred_dist[ri], batch.entity_gids[ri], batch.query_entities[ri],
                    self.vocab.num_entity, ignore_prob)
                _, _, _, _, _, _, retrieved = f1_and_hits_eval(
                    [], cand2prob, self.cfg.model.eps)
                results.append({"cand": [[self.vocab.id2entity.get(c, c), float(p)]
                                         for c, p in retrieved],
                                "paths": []})
                ri += 1

        if with_paths and self.extractor is not None:
            with record_function("retrieve/paths"):
                all_paths = self.extractor.extract([
                    {"graph": q["subgraph"]["tuples"],
                     "q_entity": q.get("entities", []),
                     "cand": [c for c, _ in res["cand"]]}
                    for q, res in zip(questions, results)])
            with record_function("retrieve/verbalize"):
                for res, paths in zip(results, all_paths):
                    res["paths"] = list(dict.fromkeys(path_to_string(p)
                                                      for p in paths))
        elif with_paths:
            for q, res in zip(questions, results):
                graph = q["subgraph"]["tuples"]
                q_entity = q.get("entities", [])
                cand = [c for c, _ in res["cand"]]
                with record_function("retrieve/paths"):
                    if self.path_backend == "python":
                        paths = get_truth_paths(
                            q_entity, cand,
                            build_graph(graph, keep_parallel=self.keep_parallel))
                    else:
                        paths = get_truth_paths_fast(
                            graph, q_entity, cand,
                            keep_parallel=self.keep_parallel)
                with record_function("retrieve/verbalize"):
                    # distinct verbalized paths, first occurrence order
                    res["paths"] = list(dict.fromkeys(path_to_string(p)
                                                      for p in paths))
        return results

    # ------------------------------------------------------------------
    def serve_http(self, host: str = "localhost", port: int = 0):
        """POST /retrieve with {"questions": [...]} -> results JSON."""
        return _serve_http(host, port, {"/retrieve": (
            lambda body: {"results": self.retrieve(
                body.get("questions", []),
                with_paths=body.get("with_paths", True))})})


class QAService:
    """End-to-end KGQA in one process: GNN retrieval -> shortest-path
    verbalization -> prompt -> LLM reader -> answer.

    The reference couples its two stages only through offline files (.info
    dumps moved by hand, gnn/README.md:22 -> predict_answer.py:43-80); here
    a question with its subgraph goes in and the read answer comes out of a
    single service, with the PromptBuilder semantics (eps-cumulative
    candidates, token-budget truncation) of the offline path."""

    def __init__(self, retriever: RetrieverService, reader, *,
                 prompt_path: str = "prompts/llama2_predict.txt",
                 top_k_cand: int = 10, keep_parallel: Optional[bool] = None):
        # reader: any rag.llms registry backend, already prepared (mock,
        # llama_tpu = LlamaTorch)
        self.retriever = retriever
        self.reader = reader
        if keep_parallel is None:
            keep_parallel = retriever.keep_parallel
        from .rag.prompt_builder import PromptBuilder
        self.builder = PromptBuilder(
            prompt_path, maximun_token=reader.maximun_token,
            tokenize=reader.tokenize, keep_parallel=keep_parallel)
        self.top_k_cand = top_k_cand

    def prompts(self, questions: Sequence[dict], retrieved: Sequence[dict]
                ) -> List[str]:
        """The reader's prompt for each question and its retrieved
        candidates (the top ``top_k_cand``)."""
        prompts = []
        for q, r in zip(questions, retrieved):
            ex = {"question": q["question"],
                  "graph": q["subgraph"]["tuples"],
                  "q_entity": q.get("entities", []),
                  "cand": [c for c, _ in r["cand"][:self.top_k_cand]],
                  "choices": q.get("choices", [])}
            prompts.append(self.builder.process_input(ex))
        return prompts

    def answer(self, questions: Sequence[dict]) -> List[dict]:
        """questions: reference JSONL schema; returns per-question
        {prediction, cand, prompt}."""
        retrieved = self.retriever.retrieve(questions, with_paths=False)
        prompts = self.prompts(questions, retrieved)
        if len(prompts) > 1 and hasattr(self.reader, "generate_batch"):
            outs = self.reader.generate_batch(prompts)
        else:
            # one prompt goes through generate_sentence, a backend's
            # single-question path
            outs = [self.reader.generate_sentence(p) for p in prompts]
        return [{"prediction": o, "cand": r["cand"], "prompt": p}
                for o, r, p in zip(outs, retrieved, prompts)]

    def serve_http(self, host: str = "localhost", port: int = 0):
        """POST /answer with {"questions": [...]} -> answers JSON; also
        exposes the retriever's /retrieve."""
        return _serve_http(host, port, {
            "/answer": (lambda body: {"results": self.answer(
                body.get("questions", []))}),
            "/retrieve": (lambda body: {"results": self.retriever.retrieve(
                body.get("questions", []),
                with_paths=body.get("with_paths", True))}),
        })


def _serve_http(host: str, port: int, routes):
    """Minimal threaded JSON-POST server over a {path: handler} table."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            handler = routes.get(self.path.rstrip("/"))
            if handler is None:
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError as exc:
                self.send_error(400, explain=str(exc))
                return
            try:
                payload = json.dumps(handler(body)).encode()
            except Exception as exc:   # noqa: BLE001 — a bad question must
                # 500 with the reason, not drop the connection and take the
                # worker thread down with it
                self.send_error(500, explain=f"{type(exc).__name__}: {exc}")
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    httpd = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd
