#!/usr/bin/env python3
"""Start the PyTorch port (gnn_rag_tpu_torch) on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the gate-scatter kernel from gnn_rag_tpu_torch/csrc/;
  3. kernel: the CUDA kernel against its plain PyTorch version on the card at
     the serving shapes (fp32 and bf16), with CUDA-event medians of both;
  3b. kernel, backward: the backward kernel against its plain version at
     the same shapes with a random cotangent (dvals, dprior, dins), two
     launches bit-identical, CUDA-event medians of both;
  4. slice: a SynthQSP split (WebQSP-scale subgraphs) served at the headline
     WebQSP ReaRev width (entity_dim 50, num_iter 3, num_ins 2, num_gnn 3,
     MiniLM-width frozen LM, random weights from a seed) through the HTTP
     retrieval server and the Evaluator's `.info` export; the launch count
     proves the forward ran the kernel, and the same batch through the plain
     path must give the same answer distribution; then the request latency
     over a window of LATENCY_PASSES passes through the split: every
     question alone, and every 16-question batch of it; then where a
     retrieve request's time goes (the service's record_function spans
     under torch.profiler) and the B16 forward's device time, kernel count
     and busy share;
  5. train: a 64-question SynthQSP train split trained for 2 epochs (B8,
     8 steps an epoch) at the headline configuration through the port's CLI
     (`python -m gnn_rag_tpu_torch ReaRev ... --device cuda`, run in this
     process), with dev/test evaluation every epoch and the checkpoints; the
     launch counts prove every step ran both kernels; the final checkpoint,
     reloaded by `--is_eval --load_experiment`, reproduces the trained
     model's test answer distribution and writes the `.info`;
  6. grad: every parameter gradient of one B8 batch through the kernels
     against the plain versions (1e-4 of the largest entry + 1e-7; the two
     softmax biases, whose gradient is 0, to |g| <= 1e-5), and one bf16
     training step;
  7. step time: a training step's time over TRAIN_STEPS steps (CUDA events),
     kernel path against plain path, and one step under torch.profiler.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
LATENCY_PASSES = 4
TRAIN_STEPS = 20
PALLAS = "gnn_rag_tpu/ops/pallas_mp.py"
# scripts/rearev_webqsp.sh with the reference's training defaults
HEADLINE_FLAGS = ["ReaRev", "--entity_dim", "50", "--num_iter", "3",
                  "--num_ins", "2", "--num_gnn", "3", "--lm", "sbert",
                  "--relation_word_emb", "True", "--batch_size", "8",
                  "--test_batch_size", "16", "--linear_dropout", "0.2",
                  "--lr", "5e-4", "--gradient_clip", "1.0",
                  "--seed", str(SEED), "--device", "cuda"]
# biases that feed only a softmax over entities or question tokens: the
# softmax is shift invariant, so their gradient is 0 up to rounding, and the
# noise (1e-7 to 3e-7; it varies run to run, as other gradients sum with
# atomics) is compared with nothing; the gradient check holds them to
# |g| <= 1e-5 on both paths
SOFTMAX_BIASES = ("reasoning.score_func.bias",
                  "instruction_decoder.ca_linear.bias")
# (name, B, E, F bucket, J, D, dtype, apply_relu): the shapes the serving
# path gives the kernel — WebQSP and CWQ serving buckets, the huge-E bucket
# the TPU needed a per-instruction tier for, and TypeLayer's J=1 call
KERNEL_SHAPES = (
    ("webqsp_fp32", 16, 2048, 8192, 2, 50, "float32", True),
    ("webqsp_bf16", 16, 2048, 8192, 2, 50, "bfloat16", True),
    ("cwq_fp32", 8, 4096, 16384, 3, 50, "float32", True),
    ("huge_e_fp32", 4, 8192, 32768, 3, 50, "float32", True),
    ("type_layer_fp32", 16, 2048, 8192, 1, 50, "float32", False),
)


def log(phase, msg):
    print(f"chip_smoke [{phase}] {msg}", flush=True)


def median_ms(fn, runs=20, reps=10, warmup=3):
    """Median over ``runs`` of the device time per call, each run timing
    ``reps`` back-to-back calls between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def kernel_inputs(B, E, F, J, D, dtype, apply_relu, device, rng):
    """Random subgraphs of ~0.75E entities and ~0.8F facts per sample, laid
    out by the port's loader code, and gate inputs on the device."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch.data.kernel_layout import (TILE_E, TILE_F,
                                                      build_sample_direction,
                                                      pack_samples)
    fwd, inv = [], []
    for _ in range(B):
        ne, nf = int(0.75 * E), int(0.8 * F)
        h = rng.integers(0, ne, nf).astype(np.int32)
        t = rng.integers(0, ne, nf).astype(np.int32)
        r = rng.integers(0, 200, nf).astype(np.int32)
        w = np.ones(nf, np.float32)
        fwd.append(build_sample_direction(t, h, r, w, E, 200))
        inv.append(build_sample_direction(h, t, r, w, E, 200))
    nc = -(-(F // TILE_F + E // TILE_E) // 8) * 8
    kl = pack_samples(fwd, inv, E, 200, num_chunks=nc)
    Fp = nc * TILE_F
    dt = getattr(torch, dtype)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    scatter = dev(np.stack([kl.fwd.scatter, kl.inv.scatter]))
    valid = (scatter >= 0).float()
    gen = torch.Generator(device=device).manual_seed(SEED)
    vals = torch.randn((2, B, Fp, D), generator=gen, device=device).to(dt)
    ins = (torch.ones((B, J, D), device=device) if not apply_relu else
           torch.randn((B, J, D), generator=gen, device=device)).to(dt)
    prior = torch.rand((2, B, Fp), generator=gen, device=device) * valid
    starts = dev(np.stack([kl.fwd.chunk_starts, kl.inv.chunk_starts]))
    # one tensor per direction, as the model passes them
    return (vals.unbind(0), ins, prior.unbind(0), scatter.unbind(0),
            starts.unbind(0), apply_relu)


def check_kernels(device):
    """Phase 3: kernel vs plain at every serving shape; returns rows."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    rng = np.random.default_rng(SEED)
    rows = []
    for name, B, E, F, J, D, dtype, relu in KERNEL_SHAPES:
        args = kernel_inputs(B, E, F, J, D, dtype, relu, device, rng)
        got = gs.gate_scatter_fwd(*args)
        torch.cuda.synchronize()
        want = gs.gate_scatter_fwd_plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        rel_tol = 1e-5 if dtype == "float32" else 2e-2
        ok = bool(torch.isfinite(got).all()) and err <= rel_tol * ref
        ms = median_ms(lambda: gs.gate_scatter_fwd(*args))
        plain_ms = median_ms(lambda: gs.gate_scatter_fwd_plain(*args))
        row = dict(shape=name, B=B, E=E, Fp=args[0][0].shape[1], J=J, D=D,
                   dtype=dtype, relu=relu, max_abs_err=err, max_abs_ref=ref,
                   tol=rel_tol * ref, ms=ms, plain_ms=plain_ms)
        log("kernel", json.dumps(row))
        if not ok:
            raise AssertionError(f"kernel disagrees with plain at {name}: "
                                 f"max|d|={err} > {rel_tol}*{ref}")
        rows.append(row)
        del args, got, want
    return rows


def check_bwd_kernels(device):
    """Phase 3b: backward kernel vs plain at every shape; returns rows."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    rows = []
    for name, B, E, F, J, D, dtype, relu in KERNEL_SHAPES:
        vals, ins, prior, scatter, starts, _ = kernel_inputs(
            B, E, F, J, D, dtype, relu, device, rng)
        g = torch.randn((2, B, E, J * D), generator=gen, device=device)
        args = (vals, ins, prior, scatter, starts, g, relu)
        got = gs.gate_scatter_bwd(*args)
        again = gs.gate_scatter_bwd(*args)
        torch.cuda.synchronize()
        want = gs.gate_scatter_bwd_plain(*args)
        torch.cuda.synchronize()
        rel_tol = 1e-5 if dtype == "float32" else 2e-2
        parts = {}
        for part, a, b in zip(("dvals_f", "dvals_i", "dprior_f", "dprior_i",
                               "dins"), (*got[0], *got[1], got[2]),
                              (*want[0], *want[1], want[2])):
            err = (a.float() - b.float()).abs().max().item()
            ref = b.float().abs().max().item()
            if not (a.dtype == b.dtype and torch.isfinite(a).all()
                    and err <= rel_tol * ref):
                raise AssertionError(f"bwd kernel disagrees with plain at "
                                     f"{name} {part}: max|d|={err} > "
                                     f"{rel_tol}*{ref}")
            parts[part] = [err, ref]
        repeat = all(torch.equal(a, b) for a, b in zip(
            (*got[0], *got[1], got[2]), (*again[0], *again[1], again[2])))
        if not repeat:
            raise AssertionError(f"bwd kernel not deterministic at {name}")
        ms = median_ms(lambda: gs.gate_scatter_bwd(*args))
        plain_ms = median_ms(lambda: gs.gate_scatter_bwd_plain(*args))
        row = dict(shape=name, B=B, E=E, Fp=vals[0].shape[1], J=J, D=D,
                   dtype=dtype, relu=relu,
                   max_abs_err=max(e for e, _ in parts.values()),
                   err_ref_by_output=parts, bit_identical_repeat=repeat,
                   ms=ms, plain_ms=plain_ms)
        log("kernel-bwd", json.dumps(row))
        rows.append(row)
        del args, got, again, want
    return rows


def make_data(root):
    """A SynthQSP split at the default (WebQSP-like) subgraph scale, from
    the repository's generator run as its own command."""
    subprocess.run([sys.executable, "-m", "gnn_rag_tpu.utils.refbench",
                    "--out", root, "--seed", str(SEED), "--n_train", "8",
                    "--n_dev", "8", "--n_test", "64"],
                   cwd=REPO, check=True, capture_output=True, text=True)


def headline_config(root, compute_dtype="float32"):
    """scripts/rearev_webqsp.sh: entity_dim 50, num_iter 3, num_ins 2,
    num_gnn 3, --lm sbert (frozen), relation_word_emb True."""
    from gnn_rag_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                          TrainConfig)
    return Config(
        data=DataConfig(name="webqsp", data_folder=root + "/", lm="sbert",
                        relation_word_emb=True),
        model=ModelConfig(entity_dim=50, num_iter=3, num_ins=2, num_gnn=3,
                          lm="sbert", compute_dtype=compute_dtype),
        train=TrainConfig(is_eval=False, test_batch_size=16, seed=SEED))


def post(url, questions):
    req = urllib.request.Request(url, data=json.dumps(
        {"questions": questions}).encode(), headers={"Content-Type":
                                                     "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())["results"]


def request_latency(url, questions):
    """Closed-loop latency of POST /retrieve, one client: each pass sends
    every question alone, then every 16-question batch of the split. Returns
    per request size the request count, p10/p50/p90 over all requests and
    each pass's p50 (their spread shows whether the p50 has settled)."""
    import numpy as np
    lat = {1: [], 16: []}
    pass_p50 = {1: [], 16: []}
    for _ in range(LATENCY_PASSES):
        for n in lat:
            this = []
            for i in range(0, len(questions) - n + 1, n):
                t = time.perf_counter()
                post(url, questions[i:i + n])
                this.append(1e3 * (time.perf_counter() - t))
            lat[n] += this
            pass_p50[n].append(float(np.median(this)))
    return {f"retrieve_b{n}": dict(
        requests=len(ms), p50_ms=float(np.median(ms)),
        p10_ms=float(np.percentile(ms, 10)),
        p90_ms=float(np.percentile(ms, 90)), pass_p50_ms=pass_p50[n])
        for n, ms in lat.items()}


def profile_slice(svc, questions, batch):
    """The retrieve stages (record_function spans of
    serve.py) per request at 1 and 16 questions, and the B16 forward under
    torch.profiler: device time, kernels, busy share, largest device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for n in (1, 16):
        reqs = [questions[i:i + n] for i in range(0, len(questions), n)]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t = time.perf_counter()
            for q in reqs:
                svc.retrieve(q)
            wall = 1e3 * (time.perf_counter() - t) / len(reqs)
        stages = {e.key.split("/", 1)[1]: e.cpu_time_total / 1e3 / len(reqs)
                  for e in prof.key_averages() if e.key.startswith("retrieve/")}
        log("profile", json.dumps(dict(
            questions_per_request=n, requests=len(reqs),
            wall_ms_per_request_under_profiler=wall,
            stage_ms_per_request=stages)))
    reps = 5
    b = batch.to(svc.device)
    with torch.inference_mode():
        for _ in range(3):
            svc.model(b, *svc.rel_args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(reps):
                svc.model(b, *svc.rel_args)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t) / reps
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
           and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3 / reps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    log("profile", json.dumps(dict(
        forward_b16_wall_ms_under_profiler=wall, device_ms=dev_ms,
        busy_share=dev_ms / wall if dev_ms else "not measured",
        device_kernels=sum(e.count for e in dev) / reps,
        top_device_ops=[[e.key[:60], e.self_device_time_total / 1e3 / reps,
                         e.count / reps] for e in top])))


def run_slice(device, root):
    """Phase 4: the serving slice at full width; returns (summary, launches)."""
    import dataclasses

    import numpy as np
    import torch
    from gnn_rag_tpu_torch.data.loader import load_dataset_dir
    from gnn_rag_tpu_torch.models.frozen_lm import (FrozenLM, encode_questions,
                                                    encode_relations)
    from gnn_rag_tpu_torch.models.rearev import build_model
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    from gnn_rag_tpu_torch.serve import RetrieverService
    from gnn_rag_tpu_torch.train.evaluate import Evaluator

    t0 = time.perf_counter()
    make_data(root)
    cfg = headline_config(root)
    bundle = load_dataset_dir(cfg)
    test, vocab, tok = bundle["test"], bundle["vocab"], bundle["tokenizer"]
    lm = FrozenLM(word_dim=384, vocab_size=30522, layers=6, heads=12,
                  intermediate=1536, seed=SEED, device=device)
    rel = encode_relations(lm, bundle["rel_tokens"], bundle["rel_tokens_inv"],
                           tok.pad_id)
    encode_questions(lm, test, tok.pad_id)
    model = build_model(cfg, vocab.num_entity, bundle["num_kb_relation"],
                        word_dim=384, seed=SEED, device=device)
    svc = RetrieverService(
        cfg, vocab, model, rel_hidden=rel[0], rel_hidden_inv=rel[1],
        rel_text_mask=rel[2], tokenizer=tok,
        question_encoder=lambda ids: lm.encode(ids[None], pad_id=tok.pad_id)[0])
    with open(os.path.join(root, "test.json")) as f:
        questions = [json.loads(line) for line in f]
    n_ent = [len(q["subgraph"]["entities"]) for q in questions]
    log("slice", f"setup {time.perf_counter() - t0:.1f} s: {len(questions)} "
        f"questions, entities mean {np.mean(n_ent):.0f} max {max(n_ent)}, "
        f"{bundle['num_kb_relation']} relations, path backend "
        f"{svc.path_backend}, frozen LM {lm.weight_source}")

    # ---- the main path, counted: two HTTP requests + the .info export ----
    httpd = svc.serve_http(port=0)
    url = f"http://localhost:{httpd.server_port}/retrieve"
    info_path = os.path.join(root, "test.info")
    evaluator = Evaluator(eps=cfg.model.eps, num_entity=vocab.num_entity,
                          id2entity=vocab.id2entity, num_iter=cfg.model.num_iter)
    try:
        gs.launches = gs.bwd_launches = 0
        res1 = post(url, questions[:1])
        res16 = post(url, questions[:16])
        f1, hit, em, loss = evaluator.evaluate(
            test, svc.forward, test_batch_size=16, write_info=True,
            info_path=info_path)
        torch.cuda.synchronize()
        launches = gs.launches
        forwards = 2 + math.ceil(len(test) / 16)
        per_forward = 1 + cfg.model.num_iter * cfg.model.num_gnn
        if launches != forwards * per_forward or gs.bwd_launches:
            raise AssertionError(f"kernel launches {launches} != {forwards} "
                                 f"forwards x {per_forward}, or backward "
                                 f"launches {gs.bwd_launches} while serving")
        latency = request_latency(url, questions)
    finally:
        httpd.shutdown()
        httpd.server_close()

    for res in [*res1, *res16]:
        probs = [p for _, p in res["cand"]]
        if not res["cand"] or probs != sorted(probs, reverse=True):
            raise AssertionError("retrieve returned no or unsorted candidates")
        if not all(" -> " in p for p in res["paths"]):
            raise AssertionError("malformed verbalized path")
    with open(info_path) as f:
        info = [json.loads(line) for line in f]
    keys = (["question"] + [str(j) for j in range(cfg.model.num_iter)]
            + ["answers", "precison", "recall", "f1", "hit", "em", "cand"])
    if len(info) != len(test) or any(list(x) != keys for x in info):
        raise AssertionError(".info lines or keys wrong")
    if not (np.isfinite(loss) and 0.0 <= f1 <= 1.0):
        raise AssertionError(f"eval loss {loss} / f1 {f1}")

    # ---- the same batch through the plain path on the card ----
    batch = test.make_batch(range(16))

    def forward_ms(fn):
        with torch.inference_mode():
            out = fn(batch)
            return out, median_ms(lambda: fn(batch), runs=10, reps=1, warmup=2)

    (_, _, dist_k), fwd_ms = forward_ms(svc.forward)
    (_, _, dist_p), fwd_plain_ms = swapped_to_plain(
        lambda: forward_ms(svc.forward))
    diff = (dist_k - dist_p).abs().max().item()
    sums = dist_k.sum(1)
    # atol 1e-5, and 1e-4 of the largest probability: only the f32 sum order
    # differs between the two paths
    if not (torch.isfinite(dist_k).all()
            and diff <= min(1e-5, 1e-4 * dist_p.abs().max().item())
            and torch.allclose(sums, torch.ones_like(sums), atol=1e-4)):
        raise AssertionError(f"pred_dist kernel vs plain max|d|={diff}")

    # ---- bfloat16 gate values through the kernel, same weights ----
    bf_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    bf_model = build_model(bf_cfg, vocab.num_entity, bundle["num_kb_relation"],
                           word_dim=384, seed=SEED, device=device)
    with torch.inference_mode():
        _, _, dist_bf = bf_model(batch.to(device), *svc.rel_args)
    bf_diff = (dist_bf - dist_k).abs().max().item()
    if not (torch.isfinite(dist_bf).all()
            and torch.allclose(dist_bf.sum(1), torch.ones_like(sums), atol=1e-3)):
        raise AssertionError("bf16 pred_dist not a distribution")

    summary = dict(
        launches=launches, forwards=forwards, info_lines=len(info),
        eval_f1=f1, eval_hit=hit, eval_loss=loss,
        cand_per_question_b16=float(np.mean([len(r["cand"]) for r in res16])),
        paths_per_question_b16=float(np.mean([len(r["paths"]) for r in res16])),
        **latency,
        forward_b16_ms=fwd_ms, forward_b16_plain_ms=fwd_plain_ms,
        pred_dist_kernel_vs_plain=diff, pred_dist_bf16_vs_fp32=bf_diff,
        batch_E=int(batch.seed_dist.shape[1]),
        batch_Fp=int(batch.layout.fwd.scatter.shape[1]))
    log("slice", json.dumps(summary))
    profile_slice(svc, questions, batch)
    return summary, launches


def run_train(device, root):
    """Phase 5: train the headline configuration for 2 epochs through the
    port's CLI, then reload its final checkpoint; returns (summary,
    trainer, forward launches, backward launches)."""
    import numpy as np
    import torch
    from gnn_rag_tpu_torch import cli
    from gnn_rag_tpu_torch.models.rearev import build_model
    from gnn_rag_tpu_torch.ops import gate_scatter as gs

    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "gnn_rag_tpu.utils.refbench",
                    "--out", root, "--seed", str(SEED), "--n_train", "64",
                    "--n_dev", "16", "--n_test", "16"],
                   cwd=REPO, check=True, capture_output=True, text=True)
    flags = HEADLINE_FLAGS + ["--data_folder", root + "/", "--checkpoint_dir",
                              os.path.join(root, "ckpt"),
                              "--experiment_name", "smoke"]
    # ---- the main path, counted: 2 epochs of training with evaluation ----
    gs.launches = gs.bwd_launches = 0
    ctx = cli.run(flags + ["--num_epoch", "2", "--eval_every", "1",
                           "--decay_rate", "0.98"])
    torch.cuda.synchronize()
    fwd, bwd = gs.launches, gs.bwd_launches
    tr, cfg = ctx["trainer"], ctx["cfg"]
    wall = time.perf_counter() - t0

    def n_batches(ds):
        return math.ceil(len(ds) / cfg.train.test_batch_size)

    written = [r for r in ("h1", "f1", "final")
               if os.path.exists(tr._ckpt_path(r))]
    steps = 2 * math.ceil(len(tr.train_data) / cfg.train.batch_size)
    evals = (2 * (n_batches(tr.valid_data) + n_batches(tr.test_data))
             + len(written) * n_batches(tr.test_data))
    per = 1 + cfg.model.num_iter * cfg.model.num_gnn
    if tr.step_count != steps or fwd != per * (steps + evals) or bwd != per * steps:
        raise AssertionError(f"train launches fwd {fwd} bwd {bwd}, expected "
                             f"{per} x ({steps} steps + {evals} eval forwards) "
                             f"and {per} x {steps}")
    history = ctx["history"]
    if not (len(history) == 2 and np.isfinite(history).all()):
        raise AssertionError(f"epoch (loss, h1, f1): {history}")
    if "final" not in written or not all(
            os.path.exists(tr._ckpt_path(r) + ".meta.json") for r in written):
        raise AssertionError(f"checkpoints written: {written}")
    init = build_model(cfg, tr.num_entity, ctx["bundle"]["num_kb_relation"],
                       word_dim=cfg.model.word_dim_effective,
                       seed=cfg.train.seed).state_dict()
    trained = tr.model.state_dict()      # the final checkpoint's weights
    changed = sum(not torch.equal(init[k], v.cpu()) for k, v in trained.items())
    if changed < len(trained) - 1:
        raise AssertionError(f"only {changed} of {len(trained)} parameters "
                             "changed in training")

    # ---- the final checkpoint, reloaded by the eval-only entry ----
    test_batch = tr.test_data.make_batch(range(16))
    with torch.inference_mode():
        dist = tr.forward(test_batch)[2]
    ctx2 = cli.run(flags + ["--is_eval", "--load_experiment", "smoke-final.ckpt"])
    with torch.inference_mode():
        dist2 = ctx2["trainer"].forward(test_batch)[2]
    reload_diff = (dist - dist2).abs().max().item()
    if not (torch.isfinite(dist2).all() and reload_diff <= 1e-6):
        raise AssertionError(f"reloaded pred_dist differs by {reload_diff}")
    info_path = os.path.join(root, "ckpt", "smoke_test.info")
    with open(info_path) as f:
        info = [json.loads(line) for line in f]
    keys = (["question"] + [str(j) for j in range(cfg.model.num_iter)]
            + ["answers", "precison", "recall", "f1", "hit", "em", "cand"])
    if len(info) != len(tr.test_data) or any(list(x) != keys for x in info):
        raise AssertionError(".info lines or keys wrong after reload")
    summary = dict(
        wall_s=wall, steps=steps, eval_forwards=evals, launches=fwd,
        bwd_launches=bwd, epochs_loss_h1_f1=history,
        checkpoints=written, params_changed=changed, params=len(trained),
        reload_pred_dist_max_diff=reload_diff, info_lines=len(info),
        test_E=int(test_batch.seed_dist.shape[1]))
    log("train", json.dumps(summary))
    return summary, tr, fwd, bwd


def swapped_to_plain(fn):
    """Run ``fn`` with both gate-scatter kernels swapped for their plain
    versions (restored afterwards)."""
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    real = gs.gate_scatter_fwd, gs.gate_scatter_bwd
    gs.gate_scatter_fwd, gs.gate_scatter_bwd = (gs.gate_scatter_fwd_plain,
                                                gs.gate_scatter_bwd_plain)
    try:
        return fn()
    finally:
        gs.gate_scatter_fwd, gs.gate_scatter_bwd = real


def check_grads(tr, device):
    """Phase 6: every parameter gradient of one B8 batch (dropout off)
    through the kernels and through the plain versions; one bf16 step."""
    import dataclasses

    import torch
    from gnn_rag_tpu_torch.models.rearev import build_model
    batch = tr.train_data.make_batch(range(8)).to(device)
    model = tr.model

    def grads():
        model.zero_grad(set_to_none=True)
        model(batch, *tr.rel_args)[0].backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    got = grads()
    want = swapped_to_plain(grads)
    worst = (0.0, "", 0.0)
    zero, smallest = {}, float("inf")
    for name, w in want.items():
        if name in SOFTMAX_BIASES:
            # its gradient is 0 but for rounding noise on both paths
            zero[name] = max(got[name].abs().max().item(), w.abs().max().item())
            if not zero[name] <= 1e-5:
                raise AssertionError(f"grad {name}: {zero[name]} is not ~0")
            continue
        err = (got[name] - w).abs().max().item()
        tol = 1e-4 * w.abs().max().item() + 1e-7
        if not err <= tol:
            raise AssertionError(f"grad {name}: kernel vs plain {err} > {tol}")
        worst = max(worst, (err / tol, name, err))
        smallest = min(smallest, w.abs().max().item())
    cfg = tr.cfg
    bf_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    bf = build_model(bf_cfg, tr.num_entity, model.num_relation,
                     word_dim=tr.rel_args[0].shape[-1], device=device)
    bf.load_state_dict(model.state_dict())
    bf(batch, *tr.rel_args, training=True, generator=tr.generator)[0].backward()
    bf_finite = all(torch.isfinite(p.grad).all() for p in bf.parameters())
    if not bf_finite:
        raise AssertionError("bf16 training step: non-finite gradients")
    summary = dict(params=len(want), worst_err_over_tol=worst[0],
                   worst_param=worst[1], worst_err=worst[2],
                   softmax_bias_max_abs_grad=zero,
                   smallest_max_abs_grad_of_the_others=smallest,
                   bf16_grads_finite=bf_finite,
                   batch_E=int(batch.seed_dist.shape[1]),
                   batch_Fp=int(batch.layout.fwd.scatter.shape[1]))
    log("grad", json.dumps(summary))
    return summary


def train_step_time(tr, device):
    """Phase 7: ms per training step (CUDA events over TRAIN_STEPS steps
    after warm-up, kernel path and plain path in turns), and one kernel-path
    step's device time, kernel count and busy share under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batch = tr.train_data.make_batch(range(8)).to(device)
    valid_w = torch.ones(8, device=device)

    def ms_per_step():
        acc = torch.zeros(4, device=device)
        for _ in range(5):
            acc = tr.train_step(batch, valid_w, acc)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TRAIN_STEPS):
            acc = tr.train_step(batch, valid_w, acc)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / TRAIN_STEPS

    kernel, plain = [], []
    for path in ("kernel", "plain", "plain", "kernel"):
        if path == "kernel":
            kernel.append(ms_per_step())
        else:
            plain.append(swapped_to_plain(ms_per_step))
    reps = 3
    acc = torch.zeros(4, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            acc = tr.train_step(batch, valid_w, acc)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t) / reps
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
           and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3 / reps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    summary = dict(
        batch=8, steps_timed=TRAIN_STEPS, ms_per_step_kernel=kernel,
        ms_per_step_plain=plain,
        subgraphs_per_s_kernel=[8e3 / x for x in kernel],
        subgraphs_per_s_plain=[8e3 / x for x in plain],
        batch_E=int(batch.seed_dist.shape[1]),
        batch_Fp=int(batch.layout.fwd.scatter.shape[1]),
        profiled_step_wall_ms=wall, device_ms=dev_ms,
        busy_share=dev_ms / wall if dev_ms else "not measured",
        device_kernels_per_step=sum(e.count for e in dev) / reps,
        top_device_ops=[[e.key[:60], e.self_device_time_total / 1e3 / reps,
                         e.count / reps] for e in top])
    log("step-time", json.dumps(summary))
    return summary


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    device = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()} torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    print(card, flush=True)

    t = time.perf_counter()
    lib = gs.build()
    ptxas = [ln.strip() for ln in gs.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", f"{os.path.relpath(lib, REPO)} in "
        f"{time.perf_counter() - t:.1f} s; {' | '.join(ptxas)}")

    rows = check_kernels(device)
    bwd_rows = check_bwd_kernels(device)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        summary, launches = run_slice(device, root)
        os.makedirs(os.path.join(root, "train"))
        train, tr, train_fwd, train_bwd = run_train(device,
                                                    os.path.join(root, "train"))
        grad = check_grads(tr, device)
        step_time = train_step_time(tr, device)

    source = "gnn_rag_tpu_torch/csrc/gate_scatter.cu"
    print(json.dumps({"kernels": [{
        "name": "gate_scatter_fwd", "route": "cuda", "source": source,
        "replaces": f"{PALLAS}:844",
        "also_replaces": [f"{PALLAS}:1231", f"{PALLAS}:565"],
        "launches": train_fwd,
        "launches_by_path": {"serve": launches, "train": train_fwd},
        "max_abs_err": rows[0]["max_abs_err"],
        "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
        "shapes": rows, "slice": summary}, {
        "name": "gate_scatter_bwd", "route": "cuda", "source": source,
        "replaces": f"{PALLAS}:988",
        "also_replaces": [f"{PALLAS}:1267", f"{PALLAS}:639"],
        "launches": train_bwd,
        "max_abs_err": bwd_rows[0]["max_abs_err"],
        "ms": bwd_rows[0]["ms"], "plain_ms": bwd_rows[0]["plain_ms"],
        "shapes": bwd_rows, "train": train, "grad": grad,
        "step_time": step_time}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
