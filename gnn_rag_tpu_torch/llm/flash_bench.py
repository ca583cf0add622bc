"""Time the flash kernels, the gate-scatter kernels and the ReaRev train
step of two (or more) trees of this repository in turns.

    python -m gnn_rag_tpu_torch.llm.flash_bench build/parent .
    python -m gnn_rag_tpu_torch.llm.flash_bench --phases gate build/other .
    python -m gnn_rag_tpu_torch.llm.flash_bench --phases exchange,clusters16 \
        --rounds 3 build/parent .

Each tree runs in a child process of its own (its own build of ``csrc/``
and its own modules), in the order given and then reversed (A B B A; A B
C C B A for three), on one card, ``--rounds`` times (default once). Each
child prints one JSON line: the tree, the card, and per phase of
``--phases`` (default all):

- ``flash``: at the SFT step's shape B8 L2047 H32 D128, in bf16, in
  float32 and (in a tree whose kernels take it) in float16, per kernel
  (fwd, dq, dkv) the CUDA-event median ms (bf16 and float16 over 10 runs
  of 5 launches, float32 over 5 runs of 2), the bound (float32:
  six bf16 tensor-core passes, and ``float_core_bound_ms`` at the float
  cores' peak), its share of the bound and the achieved TFLOP/s, and each
  output's largest ratio to its tolerance against the plain versions (dq,
  dk and dv also from the plain forward's lse and delta, the same inputs
  in both trees) and a digest of each output (o, lse, dq, dk, dv; dq and
  dk/dv from the kernels' own lse and delta), so that two trees' outputs
  can be told identical bit for bit; then head dim 256 at Gemma-2B's 8
  heads, in bf16 at B2 and B8 L2047 (``D256_SHAPES``) and in float32 at
  B2 L2047 (the Gemma-2B-width float32 SFT step's shape,
  ``D256_FP32_SHAPE``), the same way, in a tree whose kernels take it
  (another tree's row says it does not), beside the float32 kernels at head dim 128 over the same blocks of
  the same work (``D128_SAME_BLOCKS``: what the head-dim-256 kernels' pairs
  of blocks cost beyond it), and in float16 at B2 L2047 H8 D256 (the
  float16 Gemma-2B-width SFT step's shape); then head dims 512 and 384 in
  bf16 and float16 at B8 L2047 H8 (``D512_SHAPES``: the step-time-llm-d512
  step's attention, DeepSeek-V4-Flash's head shape), and in float32 at B2
  L2047 H8 (``D512_FP32_SHAPES``: the step-time-llm-d512-fp32 step's), in
  a tree whose kernels take them, each beside the float32 kernels at head
  dim 128 over the same blocks of the same work (what the clusters of four
  and three blocks cost beyond it); and ``sass``, a digest of each flash kernel's machine
  code (its SASS instructions, addresses and encodings stripped, keyed by
  kernel, head dim and, for float16, type: the bf16 instances keep the
  keys of trees whose kernels are templates on the head dim alone), so
  that two trees' kernels can be told identical;
- ``gate``: the gate-scatter kernels of ``ops.gate_scatter``: the v4
  forward K1 (both directions) at every row of chip_smoke's
  ``KERNEL_SHAPES`` and the skewed WebQSP layout ``SKEWED``; the v4
  backward K2 (both directions), the fused-projection forward K6a/b and
  backward K6c (one direction) and scatter_mm K6d (C = J*D) at its
  kernel-fused shapes (WebQSP fp32 and bf16, CWQ fp32) and ``SKEWED``
  (inputs from this tree's ``kernel_inputs``): ``ms``, the CUDA-event
  median over 20 runs of 10 back-to-back calls (``median_ms``: the
  wrapper's host time where that is longer than the kernels'), and
  ``device_ms``, the same from replays of a CUDA graph of the calls
  (``graph_ms``: the kernels alone), the bound, the share of it that each
  reaches, and each output's largest ratio to its tolerance against the
  plain version; for K1 also ``host_ms``, the host clock per call over
  1,000 calls, in 10 batches of 100 back-to-back calls each timed from a
  synchronised device to its last call's return (so the launch queue never
  fills and the time is the host's);
- ``wide16``: the bf16 and float16 kernels at head dims 640-1024 at B8
  L2047 H4 and at 2048 at B8 L2047 H2 (``WIDE16_SHAPES``: the
  step-time-llm-d1024 and -d2048 steps' attention), timed as the float32
  rows (5 runs of 2), in a tree whose kernels take them, and the ``sass``
  digests;
- ``clusters16``: the kernels in clusters of up to sixteen blocks
  (``CLUSTERS16_SHAPES``): float32 at head dims 640-1024 at B2 L2047 H4
  (the step-time-llm-d1024-fp32 step's attention: five to eight blocks),
  at 1152 at B2 L1000 H2 (nine) and at 2048 at B2 L2047 H2 (the
  step-time-llm-d2048-fp32 step's: sixteen), bf16 at 640 and 1024 at B8
  L2047 H4 (three and four blocks) and at 2048 at B8 L2047 H2 (eight),
  bf16 and float16 at 4096 at B8 L2047 H1 (the step-time-llm-d4096 step's:
  sixteen), timed as the float32 rows, in a tree whose kernels take them,
  with the outputs' digests, and the ``sass`` digests;
- ``exchange``: the kernels whose cluster exchange is a reduce-scatter,
  at every cluster size they run: the bf16 forward at head dim 256 NB,
  three to sixteen blocks, at B8 L2047 H1 (the step-time-llm-d4096 step's
  rows), and the float32 forward, dq and dk/dv at 128 NB, five to sixteen
  blocks, at B2 L2047 H1: the CUDA-event median ms (10 runs of 5 launches;
  ``ms_runs``, each run's ms a launch, for the spread), the bound and its
  share, PyTorch's causal SDPA on the same inputs (``sdpa_ms``: its
  forward, or its backward, which computes dq, dk and dv together, and
  ``sdpa_yardstick_ms``, the kernel's share of it by the products each
  needs: all of the forward, 3/7 of the backward for dq, 4/7 for dk/dv),
  and the digests of the outputs (o and lse; dq, and dk and dv, from the
  forward's own lse and delta), and the ``sass`` digests;
- ``shares3``: float32 at head dim 2048 at B2 L2047 H2 (the
  step-time-llm-d2048-fp32 step's attention) and at 2304 at B2 L2047 H1
  (the step-time-llm-d2304-fp32 step's: twelve blocks of 192-column
  shares), timed as the float32 rows, in a tree whose kernels take them,
  and the ``sass`` digests. To time the 192-column-share kernels at 2048
  (eleven blocks: ten of 192 columns, one of 128) against the sixteen
  128-column blocks that run it, copy this tree under ``build/``, set
  ``SHARES3_MIN_HD`` to 2048 in the copy's ``csrc/flash_attention.cu``
  (``sed``) and give both trees;
- ``steps``: the headline ReaRev configuration (chip_smoke's
  ``HEADLINE_FLAGS``, random weights) on one B8 batch of a 64-question
  SynthQSP split made once for both trees: ms a train step
  (``ms_per_step``, CUDA events around 20 steps) on the v2 and the v4 path
  in eight windows in turns, and three profiled steps of each path (device
  ms a step, busy share, each gate-scatter kernel's device ms and launches
  a step).

The timing, bound and tolerance helpers are ``chip_smoke.py``'s, loaded
from this tree. Needs a CUDA card; imports nothing at module level but the
standard library, so a child can load it by path.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
PHASES = ("flash", "gate", "steps", "wide16", "clusters16", "shares3",
          "exchange")
SHAPE = (8, 2047, 32, 128)         # B, L, H, D of the SFT step's attention
# bf16 at head dim 256: the Gemma-2B-width SFT step's attention (B2) and B8
D256_SHAPES = ((2, 2047, 8, 256), (8, 2047, 8, 256))
# float32 at head dim 256: the float32 Gemma-2B-width SFT step's attention
D256_FP32_SHAPE = (2, 2047, 8, 256)
# float16 at head dim 256: the float16 Gemma-2B-width SFT step's attention
D256_F16_SHAPE = (2, 2047, 8, 256)
# the 16-bit kernels at head dims 512 and 384 (the pair kernels): the
# DeepSeek-V4-Flash-head-shape SFT step's attention, and the same at 384
D512_SHAPES = ((8, 2047, 8, 512), (8, 2047, 8, 384))
# the float32 kernels at head dims 512 and 384 (clusters of four and three
# blocks): the float32 DeepSeek-V4-Flash-head-shape SFT step's attention
D512_FP32_SHAPES = ((2, 2047, 8, 512), (2, 2047, 8, 384))
# the 16-bit kernels at head dims 640-1024 (the step-time-llm-d1024 steps'
# attention, B8 L2047 H4) and 2048 (the step-time-llm-d2048 step's, H2)
WIDE16_SHAPES = (*((8, 2047, 4, d) for d in (640, 768, 896, 1024)),
                 (8, 2047, 2, 2048))
# the kernels in clusters of up to sixteen blocks: float32 at head dims
# 640-1024 (the step-time-llm-d1024-fp32 step's attention, B2 L2047 H4),
# 1152 (nine blocks, B2 L1000 H2) and 2048 (the step-time-llm-d2048-fp32
# step's, H2), bf16 at 640 and 1024 (three and four blocks, B8 L2047 H4)
# and 2048 (eight, H2), bf16 and float16 at 4096 (the step-time-llm-d4096
# step's, B8 L2047 H1)
CLUSTERS16_SHAPES = (*(((2, 2047, 4, d), "float32")
                       for d in (640, 768, 896, 1024)),
                     ((2, 1000, 2, 1152), "float32"),
                     ((2, 2047, 2, 2048), "float32"),
                     ((8, 2047, 4, 640), "bfloat16"),
                     ((8, 2047, 4, 1024), "bfloat16"),
                     ((8, 2047, 2, 2048), "bfloat16"),
                     ((8, 2047, 1, 4096), "bfloat16"),
                     ((8, 2047, 1, 4096), "float16"))
# the kernels of the reduce-scatter exchange at every cluster size they
# run: the 16-bit forward at 256 NB (NB 3 to 16) and the float32 forward,
# dq and dk/dv at 128 NB (NB 5 to 16)
EXCHANGE_SHAPES = (*(("fwd", (8, 2047, 1, 256 * nb), "bfloat16")
                     for nb in range(3, 17)),
                   *((kind, (2, 2047, 1, 128 * nb), "float32")
                     for kind in ("dq", "fwd", "dkv")
                     for nb in range(5, 17)))
# float32 at head dims 2048 (the step-time-llm-d2048-fp32 step's attention,
# B2 L2047 H2) and 2304 (the step-time-llm-d2304-fp32 step's, H1)
SHARES3_SHAPES = ((2, 2047, 2, 2048), (2, 2047, 1, 2304))
# the float32 kernels at head dim 128 over the blocks of that shape: B2
# L2047 H16 gives as many blocks as the head-dim-256 row's pairs, each of
# the same work (128 columns), without the exchange between the two
D128_SAME_BLOCKS = (2, 2047, 16, 128)
TIMING = dict(runs=10, reps=5, warmup=2)
# the flash kernels' timing by type: the float32 ones take ~5-25 ms a launch
FLASH_TIMING = {"bfloat16": TIMING, "float32": dict(runs=5, reps=2, warmup=1),
                "float16": TIMING}
# a child loads this file by path and measures the tree in argv[2]
_CHILD = ("import importlib.util as u, sys; "
          "s = u.spec_from_file_location('flash_bench', sys.argv[1]); "
          "m = u.module_from_spec(s); s.loader.exec_module(m); "
          "m.measure(sys.argv[2], sys.argv[3].split(','), sys.argv[4])")
# the gate-scatter kernels a profiled step reports: chip_smoke's, and those
# of older trees: the dins reduction of trees whose part_reduce_kernel takes
# one direction, the one-block-a-tile forward (K1) and the fused forward's
# own partial-tile sum
OLDER_KERNEL_NAMES = ("dins_reduce_kernel", "gate_scatter_fwd_kernel",
                      "fused_fwd_sum_kernel")
HOST_BATCHES, HOST_CALLS = 10, 100   # K1 calls timed on the host clock


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree, phases, data):
    """One tree's phases; prints one JSON line."""
    import torch
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import gnn_rag_tpu_torch
    if not gnn_rag_tpu_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"flash_bench: imported "
                           f"{gnn_rag_tpu_torch.__file__}, not {tree}")
    smoke = _load("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    if not torch.cuda.is_available():
        raise SystemExit("flash_bench: needs a CUDA card")
    device = torch.device("cuda", 0)
    out = {}
    if "flash" in phases:
        from gnn_rag_tpu_torch.llm import flash_attention as fa

        def takes(dtype, hd=256):
            return hd in getattr(fa, "HEAD_DIMS", {}).get(dtype, ())

        missing = "not taken by this tree's kernels"
        # every tree's kernels take bf16 and float32 at head dim 128
        out["flash"] = {dtype: (measure_flash(smoke, device, dtype, timing)
                                if dtype != "float16"
                                or takes(torch.float16, 128) else missing)
                        for dtype, timing in FLASH_TIMING.items()}
        out["flash_d256"] = {
            f"B{shape[0]}": (measure_flash(smoke, device, "bfloat16", TIMING,
                                           shape)
                             if takes(torch.bfloat16) else missing)
            for shape in D256_SHAPES}
        out["flash_d256_fp32"] = {
            f"B{D256_FP32_SHAPE[0]}": (
                measure_flash(smoke, device, "float32",
                              FLASH_TIMING["float32"], D256_FP32_SHAPE)
                if takes(torch.float32) else missing),
            "d128_same_blocks": measure_flash(
                smoke, device, "float32", FLASH_TIMING["float32"],
                D128_SAME_BLOCKS)}
        out["flash_d256_f16"] = {
            f"B{D256_F16_SHAPE[0]}": (
                measure_flash(smoke, device, "float16", TIMING, D256_F16_SHAPE)
                if takes(torch.float16) else missing)}
        out["flash_d512"] = {
            f"D{shape[3]} {dtype}": (
                measure_flash(smoke, device, dtype, TIMING, shape)
                if takes(getattr(torch, dtype), shape[3]) else missing)
            for shape in D512_SHAPES for dtype in ("bfloat16", "float16")}
        out["flash_d512_fp32"] = {
            f"D{shape[3]}": (
                measure_flash(smoke, device, "float32",
                              FLASH_TIMING["float32"], shape)
                if takes(torch.float32, shape[3]) else missing)
            for shape in D512_FP32_SHAPES}
        # head dim 128 at H x D / 128 heads: as many blocks, each of the
        # same work (128 columns), as the clusters of D / 128 blocks
        out["flash_d512_fp32"].update({
            f"d128_same_blocks_D{D}": measure_flash(
                smoke, device, "float32", FLASH_TIMING["float32"],
                (B, L, H * D // 128, 128))
            for B, L, H, D in D512_FP32_SHAPES})
        out["sass"] = sass_digests(fa.build())
    if "wide16" in phases:
        from gnn_rag_tpu_torch.llm import flash_attention as fa
        out["flash_wide16"] = {
            f"D{shape[3]} {dtype}": (
                measure_flash(smoke, device, dtype, FLASH_TIMING["float32"],
                              shape)
                if shape[3] in fa.HEAD_DIMS[getattr(torch, dtype)]
                else "not taken by this tree's kernels")
            for shape in WIDE16_SHAPES for dtype in ("bfloat16", "float16")}
        out["sass"] = sass_digests(fa.build())
    if "clusters16" in phases:
        from gnn_rag_tpu_torch.llm import flash_attention as fa
        out["flash_clusters16"] = {
            f"D{shape[3]} {dtype}": (
                measure_flash(smoke, device, dtype, FLASH_TIMING["float32"],
                              shape)
                if shape[3] in fa.HEAD_DIMS[getattr(torch, dtype)]
                else "not taken by this tree's kernels")
            for shape, dtype in CLUSTERS16_SHAPES}
        out["sass"] = sass_digests(fa.build())
    if "exchange" in phases:
        from gnn_rag_tpu_torch.llm import flash_attention as fa
        out["flash_exchange"] = {
            f"{kind} D{shape[3]} {dtype}": measure_exchange(
                smoke, device, kind, dtype, shape)
            for kind, shape, dtype in EXCHANGE_SHAPES}
        out["sass"] = sass_digests(fa.build())
    if "shares3" in phases:
        from gnn_rag_tpu_torch.llm import flash_attention as fa
        out["flash_shares3"] = {
            f"D{shape[3]}": (
                measure_flash(smoke, device, "float32",
                              FLASH_TIMING["float32"], shape)
                if shape[3] in fa.HEAD_DIMS[torch.float32]
                else "not taken by this tree's kernels")
            for shape in SHARES3_SHAPES}
        out["sass"] = sass_digests(fa.build())
    if "gate" in phases:
        out["gate_scatter"] = measure_gate(smoke, device)
    if "steps" in phases:
        out["steps"] = measure_steps(smoke, device, data)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps(dict(tree=os.path.relpath(tree, REPO), card=smi[:1],
                          **out)), flush=True)


def sass_digests(lib):
    """{kernel<head dim>: sha256 of its SASS instructions} of a flash
    library (``cuobjdump -sass``; addresses, encodings and the file's
    namespace hash stripped; a kernel that is no template counts as head
    dim 128; a 16-bit kernel's element type is part of the key only for
    float16, ``kernel<__half,head dim>``, so that the bf16 instances keep
    the keys of trees whose kernels are templates on the head dim alone)."""
    import hashlib
    import re

    from gnn_rag_tpu_torch.utils import build
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    digests, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_(?:fwd|dq|dkv)_"
                          r"(?:sm90|split3|pair|cluster|shares3)_kernel)"
                          r"(?:I(?:13__nv_bfloat16|(6__half))?Li(\d+)E)?",
                          line)
            name = (f"{m.group(1)}<{'__half,' if m.group(2) else ''}"
                    f"{m.group(3) or 128}>" if m else None)
            if name:
                digests[name] = hashlib.sha256()
        elif name:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
            if m:
                digests[name].update(m.group(1).encode())
    return {k: h.hexdigest()[:16] for k, h in sorted(digests.items())}


def measure_flash(smoke, device, dtype, timing, shape=SHAPE):
    """The flash kernels in ``dtype`` at ``shape`` (B, L, H, D): errors
    against the plain versions, then times."""
    import torch
    from gnn_rag_tpu_torch.llm import flash_attention as fa
    B, L, H, D = shape
    gen = torch.Generator(device=device).manual_seed(smoke.SEED + 2)
    q, k, v, g = (torch.randn(shape, generator=gen, device=device)
                  .to(getattr(torch, dtype)) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v)
    delta = fa.bwd_delta(o, g)
    got = (o, lse, fa.flash_dq(q, k, v, g, lse, delta),
           *fa.flash_dkv(q, k, v, g, lse, delta))
    po, plse = fa.flash_fwd_plain(q, k, v)
    pdelta = fa.bwd_delta(po, g)
    want = (po, plse, fa.flash_dq_plain(q, k, v, g, plse, pdelta),
            *fa.flash_dkv_plain(q, k, v, g, plse, pdelta))
    errs = {name: smoke.attn_err(a, b)[2] for name, a, b in
            zip(("o", "lse", "dq", "dk", "dv"), got, want)}
    # dq and dk/dv fed the plain forward's lse and delta: both trees'
    # kernels on the same inputs, so the ratios compare the kernels alone
    same = (fa.flash_dq(q, k, v, g, plse, pdelta),
            *fa.flash_dkv(q, k, v, g, plse, pdelta))
    errs.update({f"{name}_same_inputs": smoke.attn_err(a, b)[2] for name, a, b
                 in zip(("dq", "dk", "dv"), same, want[2:])})
    digests = {name: digest(t) for name, t in
               zip(("o", "lse", "dq", "dk", "dv"), got)}
    del got, want, same, po, plse, pdelta
    torch.cuda.empty_cache()
    calls = {"fwd": lambda: fa.flash_fwd(q, k, v),
             "dq": lambda: fa.flash_dq(q, k, v, g, lse, delta),
             "dkv": lambda: fa.flash_dkv(q, k, v, g, lse, delta)}
    bounds = smoke.attn_bounds(B, L, H, D, dtype)
    flops = smoke.attn_flops(B, L, H, D)
    kernels = {}
    for name, fn in calls.items():
        ms = smoke.median_ms(fn, **timing)
        kernels[name] = dict(ms=ms, bound_ms=bounds[name][0],
                             bound_share=bounds[name][0] / ms,
                             tflops=flops[name] / ms / 1e9)
        if dtype == "float32":
            kernels[name]["float_core_bound_ms"] = smoke.attn_bounds(
                B, L, H, D, dtype, float_cores=True)[name][0]
    del q, k, v, g, o, lse, delta, calls
    torch.cuda.empty_cache()
    return dict(shape=f"B{B} L{L} H{H} D{D} {dtype}", kernels=kernels,
                err_over_tol=errs, digests=digests)


def digest(t):
    """sha256 of a tensor's bytes (its first 16 hex digits)."""
    import hashlib

    import torch
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()[:16]


def measure_exchange(smoke, device, kind, dtype, shape):
    """One kernel (``fwd``, ``dq`` or ``dkv``) in ``dtype`` at ``shape``
    (B, L, H, D): its outputs' digests (the backward's from the forward's
    own lse and delta), its CUDA-event times, 10 runs of 5 launches, and
    SDPA's on the same inputs."""
    import torch
    import torch.nn.functional as F
    from gnn_rag_tpu_torch.llm import flash_attention as fa
    B, L, H, D = shape
    gen = torch.Generator(device=device).manual_seed(smoke.SEED + 2)
    q, k, v, g = (torch.randn(shape, generator=gen, device=device)
                  .to(getattr(torch, dtype)) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v)
    delta = fa.bwd_delta(o, g)
    if kind == "fwd":
        fn, outs = (lambda: fa.flash_fwd(q, k, v)), {"o": o, "lse": lse}
    elif kind == "dq":
        fn = lambda: fa.flash_dq(q, k, v, g, lse, delta)   # noqa: E731
        outs = {"dq": fn()}
    else:
        fn = lambda: fa.flash_dkv(q, k, v, g, lse, delta)  # noqa: E731
        outs = dict(zip(("dk", "dv"), fn()))
    runs = []
    ms = smoke.median_ms(fn, runs=10, reps=5, warmup=2, out=runs)
    bound = smoke.attn_bounds(B, L, H, D, dtype)[kind][0]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    if kind == "fwd":
        with torch.no_grad():
            sdpa = smoke.median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), runs=10, reps=5, warmup=2)
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        gt = g.transpose(1, 2)
        sdpa = smoke.median_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), gt, retain_graph=True), runs=10, reps=5,
            warmup=2)
    share = {"fwd": 1.0, "dq": 3 / 7, "dkv": 4 / 7}[kind]
    row = dict(shape=f"B{B} L{L} H{H} D{D} {dtype}", ms=ms, ms_runs=runs,
               bound_ms=bound, bound_share=bound / ms,
               sdpa_backend=smoke.sdpa_backend(qt, kt, vt), sdpa_ms=sdpa,
               sdpa_yardstick_ms=share * sdpa,
               digests={name: digest(t) for name, t in outs.items()})
    del q, k, v, g, o, lse, delta, outs, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def measure_gate(smoke, device):
    """{shape: {kernel: ms, device ms, bound, shares of the bound, largest
    error over tolerance}} of the tree's gate-scatter kernels: the v4
    forward (K1, both directions; and its host ms a call) at every kernel
    shape; at the kernel-fused shapes also the v4 backward (K2, both
    directions), the fused-projection forward (K6a/b) and backward (K6c,
    one direction) and scatter_mm (K6d)."""
    import math

    import numpy as np
    import torch
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    rng = np.random.default_rng(smoke.SEED)
    gen = torch.Generator(device=device).manual_seed(smoke.SEED + 3)
    fused = set(smoke.FUSED_SHAPES) | {smoke.SKEWED[0]}
    out = {}
    for name, B, E, F, J, D, dtype, relu in (*smoke.KERNEL_SHAPES,
                                             smoke.SKEWED):
        vals, ins, prior, scatter, starts, _ = smoke.kernel_inputs(
            B, E, F, J, D, dtype, relu, device, rng,
            skew=name == smoke.SKEWED[0])
        bf16 = ins.dtype == torch.bfloat16
        both = (vals, ins, prior, scatter, starts)
        Fp = vals[0].shape[1]
        row = dict(B=B, E=E, Fp=Fp, J=J, D=D, dtype=dtype, scatter_C=J * D)
        # (kernel, plain, bound, tolerance: a share of max|ref| or (bf16
        # steps,) per element, as chip_smoke holds them)
        calls = {"k1": (lambda: gs.gate_scatter_fwd(*both, relu),
                        lambda: gs.gate_scatter_fwd_plain(*both, relu),
                        smoke.gate_bound(row, False), 2e-2 if bf16 else 1e-5)}
        if name in fused:
            w = (torch.randn((D, D), generator=gen, device=device)
                 / math.sqrt(D)).to(ins.dtype)
            b = (0.1 * torch.randn((D,), generator=gen, device=device)).to(ins.dtype)
            g2 = torch.randn((2, B, E, J * D), generator=gen, device=device)
            one = (vals[0], w, b, ins, prior[0], scatter[0], starts[0])
            tiles = smoke.chunk_tiles_of(starts[0], Fp // 128)
            sv = torch.randn((B, Fp, J * D), generator=gen,
                             device=device).to(ins.dtype)
            calls.update({
                "k2": (lambda: gs.gate_scatter_bwd(*both, g2, relu),
                       lambda: gs.gate_scatter_bwd_plain(*both, g2, relu),
                       smoke.gate_bound(row, True), 2e-2 if bf16 else 1e-5),
                "k6ab": (lambda: gs.fused_gate_scatter_fwd(*one, relu),
                         lambda: gs.fused_gate_scatter_fwd_plain(*one, relu),
                         smoke.gate_bound(row, False, ndir=1, project=True),
                         (2,) if bf16 else 1e-5),
                "k6c": (lambda: gs.fused_gate_scatter_bwd(*one, g2[0], relu),
                        lambda: gs.fused_gate_scatter_bwd_plain(*one, g2[0], relu),
                        smoke.gate_bound(row, True, ndir=1, project=True), None),
                "k6d": (lambda: gs.scatter_mm_fwd(sv, scatter[0], tiles, E),
                        lambda: gs.scatter_mm_fwd_plain(sv, scatter[0], tiles, E),
                        smoke.scatter_bound(row), 1e-5)})
        res = {}
        for kernel, (fn, plain, (bound, _), rule) in calls.items():
            got, want = _flat(fn()), _flat(plain())
            over = 0.0
            for a, r in zip(got, want):
                d = (a.float() - r.float()).abs()
                rl = rule
                if rl is None:    # K6c: bf16 outputs one step, float 1e-4
                    rl = (1,) if r.dtype == torch.bfloat16 else 1e-4
                tol = (smoke.bf16_tol(r, *rl) if isinstance(rl, tuple)
                       else rl * r.float().abs().max())
                over = max(over, d.div(tol).nan_to_num(nan=0.0).max().item())
            ms, device_ms = smoke.median_ms(fn), smoke.graph_ms(fn)
            res[kernel] = dict(ms=ms, device_ms=device_ms, bound_ms=bound,
                               bound_share=bound / ms,
                               device_bound_share=bound / device_ms,
                               err_over_tol=over)
            if kernel == "k1":
                res[kernel]["host_ms"] = host_ms(fn)
            del got, want
        out[name] = res
        del vals, ins, prior, scatter, starts, both, calls
        torch.cuda.empty_cache()
    return out


def host_ms(fn):
    """Host-clock ms a call of ``fn`` over HOST_BATCHES batches of
    HOST_CALLS calls, each batch started on a synchronised device and timed
    to its last call's return."""
    import time

    import torch
    total = 0.0
    for _ in range(HOST_BATCHES):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        total += time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e3 * total / (HOST_BATCHES * HOST_CALLS)


def measure_steps(smoke, device, data):
    """The headline ReaRev B8 train step on the split in ``data``: ms a
    step on the v2 and v4 paths in eight windows in turns, then three
    profiled steps of each path."""
    import torch
    from gnn_rag_tpu_torch import cli
    before = os.environ.get("GNN_RAG_GATE_SCATTER")
    ctx = cli.assemble(smoke.HEADLINE_FLAGS + [
        "--data_folder", data + "/", "--checkpoint_dir",
        os.path.join(data, "ckpt"), "--experiment_name", "bench"])
    tr = ctx["trainer"]
    try:
        batch = tr.train_data.make_batch(range(8)).to(device)
        valid_w = torch.ones(8, device=device)
        walls = {"v2": [], "v4": []}
        for variant in ("v2", "v4", "v4", "v2") * 2:
            os.environ["GNN_RAG_GATE_SCATTER"] = variant
            walls[variant].append(smoke.ms_per_step(tr, batch, valid_w))
        profiled = {}
        for variant in ("v4", "v2"):
            os.environ["GNN_RAG_GATE_SCATTER"] = variant
            p = smoke.profile_step(
                tr, batch, valid_w,
                names=smoke.GATE_KERNEL_NAMES + OLDER_KERNEL_NAMES)
            profiled[variant] = {k: p[k] for k in (
                "profiled_step_wall_ms", "device_ms", "busy_share",
                "device_kernels_per_step", "gate_scatter_ms_launches")}
    finally:
        tr.close()
        if before is None:
            os.environ.pop("GNN_RAG_GATE_SCATTER", None)
        else:
            os.environ["GNN_RAG_GATE_SCATTER"] = before
    return dict(batch=8, steps_timed=smoke.TRAIN_STEPS,
                batch_E=int(batch.seed_dist.shape[1]),
                batch_Fp=int(batch.layout.fwd.scatter.shape[1]),
                ms_per_step=walls, profiled=profiled)


def _flat(x):
    """The tensors of a kernel's result (nested tuples, None skipped)."""
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x if item is not None for t in _flat(item)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+",
                    help="two or more repository roots")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases of " + ", ".join(PHASES))
    ap.add_argument("--rounds", type=int, default=1,
                    help="A B B A rounds (default 1)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if len(args.trees) < 2:
        ap.error("give two or more trees")
    if not phases or set(phases) - set(PHASES):
        ap.error(f"--phases: {args.phases!r} (choose from {PHASES})")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as data:
        if "steps" in phases:
            smoke = _load("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
            smoke.refbench(data, n_train=64, n_dev=16, n_test=16)
        for tree in (args.trees + args.trees[::-1]) * args.rounds:
            subprocess.run([sys.executable, "-c", _CHILD,
                            os.path.abspath(__file__), tree,
                            ",".join(phases), data], cwd=REPO, check=True)


if __name__ == "__main__":
    main()
