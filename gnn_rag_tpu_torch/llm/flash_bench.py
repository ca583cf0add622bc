"""Time the bf16 flash kernels and the fused-projection backward of two
trees of this repository in turns.

    python -m gnn_rag_tpu_torch.llm.flash_bench build/parent .

Each tree runs in a child process of its own (its own build of
``csrc/flash_attention.cu`` and its own ``flash_attention`` module), in the
order given and then reversed (A B B A), at the SFT step's shape B8 L2047
H32 D128 bf16 on one card. Each child prints one JSON line: the tree, the
card, and per kernel (fwd, dq, dkv) the CUDA-event median ms over 10 runs
of 5 launches, the bound, its share of the bound and the achieved TFLOP/s,
and each output's largest ratio to its tolerance against the plain
versions (dk and dv also from the plain forward's lse and delta, the same
inputs in both trees); then the fused-projection backward (K6c,
``ops.gate_scatter.fused_gate_scatter_bwd``) at chip_smoke's kernel-fused
shapes (WebQSP fp32 and bf16, CWQ fp32, and the skewed WebQSP layout; one
direction, inputs from this tree's ``kernel_inputs``): CUDA-event median ms
over 20 runs of 10 launches, the bound, and each output's largest ratio to
its tolerance against the plain version. The timing, bound and tolerance
helpers are ``chip_smoke.py``'s, loaded from this tree. Needs a CUDA card; imports nothing at module level
but the standard library, so a child can load it by path.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SHAPE = (8, 2047, 32, 128)         # B, L, H, D of the SFT step's attention
TIMING = dict(runs=10, reps=5, warmup=2)
# a child loads this file by path and measures the tree in argv[2]
_CHILD = ("import importlib.util as u, sys; "
          "s = u.spec_from_file_location('flash_bench', sys.argv[1]); "
          "m = u.module_from_spec(s); s.loader.exec_module(m); "
          "m.measure(sys.argv[2])")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree):
    """One tree's kernels: errors against the plain versions, then times."""
    import torch
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from gnn_rag_tpu_torch.llm import flash_attention as fa
    if not fa.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"flash_bench: imported {fa.__file__}, not {tree}")
    smoke = _load("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    if not torch.cuda.is_available():
        raise SystemExit("flash_bench: needs a CUDA card")
    device = torch.device("cuda", 0)
    B, L, H, D = SHAPE
    gen = torch.Generator(device=device).manual_seed(smoke.SEED + 2)
    q, k, v, g = (torch.randn(SHAPE, generator=gen, device=device)
                  .to(torch.bfloat16) for _ in range(4))
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
    # dk/dv fed the plain forward's lse and delta: both trees' kernels on
    # the same inputs, so the ratios compare the kernels alone
    same = fa.flash_dkv(q, k, v, g, plse, pdelta)
    errs.update({f"{name}_same_inputs": smoke.attn_err(a, b)[2] for name, a, b
                 in zip(("dk", "dv"), same, want[3:])})
    del got, want, same, po, plse, pdelta
    torch.cuda.empty_cache()
    calls = {"fwd": lambda: fa.flash_fwd(q, k, v),
             "dq": lambda: fa.flash_dq(q, k, v, g, lse, delta),
             "dkv": lambda: fa.flash_dkv(q, k, v, g, lse, delta)}
    bounds = smoke.attn_bounds(B, L, H, D, "bfloat16")
    flops = smoke.attn_flops(B, L, H, D)
    kernels = {}
    for name, fn in calls.items():
        ms = smoke.median_ms(fn, **TIMING)
        kernels[name] = dict(ms=ms, bound_ms=bounds[name][0],
                             bound_share=bounds[name][0] / ms,
                             tflops=flops[name] / ms / 1e9)
    fused = measure_fused(smoke, device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps(dict(tree=os.path.relpath(tree, REPO), card=smi[:1],
                          shape="B8 L2047 H32 D128 bf16", kernels=kernels,
                          err_over_tol=errs, fused_bwd=fused)), flush=True)


def measure_fused(smoke, device):
    """{shape: ms, bound, share of the bound, largest error over tolerance}
    of the tree's fused-projection backward kernel."""
    import math

    import numpy as np
    import torch
    from gnn_rag_tpu_torch.ops import gate_scatter as gs
    rng = np.random.default_rng(smoke.SEED)
    gen = torch.Generator(device=device).manual_seed(smoke.SEED + 3)
    rows = [r for r in smoke.KERNEL_SHAPES if r[0] in smoke.FUSED_SHAPES]
    out = {}
    for name, B, E, F, J, D, dtype, relu in rows + [smoke.FUSED_SKEWED]:
        vals, ins, prior, scatter, starts, _ = smoke.kernel_inputs(
            B, E, F, J, D, dtype, relu, device, rng,
            skew=name == smoke.FUSED_SKEWED[0])
        w = (torch.randn((D, D), generator=gen, device=device)
             / math.sqrt(D)).to(ins.dtype)
        b = (0.1 * torch.randn((D,), generator=gen, device=device)).to(ins.dtype)
        g = torch.randn((B, E, J * D), generator=gen, device=device)
        args = (vals[0], w, b, ins, prior[0], scatter[0], starts[0], g, relu)
        got = gs.fused_gate_scatter_bwd(*args)
        want = gs.fused_gate_scatter_bwd_plain(*args)
        over = 0.0
        for i, (a, r) in enumerate(zip(got, want)):
            d = (a.float() - r.float()).abs()
            tol = (smoke.bf16_tol(r) if r.dtype == torch.bfloat16
                   else 1e-4 * r.float().abs().max())
            over = max(over, d.div(tol).nan_to_num(nan=0.0).max().item())
        ms = smoke.median_ms(lambda: gs.fused_gate_scatter_bwd(*args))
        row = dict(B=B, E=E, Fp=vals[0].shape[1], J=J, D=D, dtype=dtype)
        bound = smoke.gate_bound(row, True, ndir=1, project=True)[0]
        out[name] = dict(ms=ms, bound_ms=bound, bound_share=bound / ms,
                         err_over_tol=over)
        del vals, args, got, want
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs=2, help="two repository roots")
    args = ap.parse_args(argv)
    for tree in args.trees + args.trees[::-1]:
        subprocess.run([sys.executable, "-c", _CHILD, os.path.abspath(__file__),
                        tree], cwd=REPO, check=True)


if __name__ == "__main__":
    main()
