"""How much the ReaRev v2 gradients of
``test_torch_cuda.py::test_rearev_v2_train_step_grads_kernel_vs_plain``
move from run to run on the card. On one model, batch and relation tensors
(that test's ``model_batch``), five runs of the plain path (the plain
gate-scatter versions) and five of the kernel path, first as they run and
then under ``torch.use_deterministic_algorithms``; prints, per mode, each
run's largest difference from the first run by parameter, and the three
parameters whose kernel-vs-plain distance is the largest share of the
test's tolerance (1e-4 of max|plain| + 1e-7) in each pair of runs.

    python tests/rearev_v2_grad_noise.py

With ``--draws N`` it runs that test's body instead over N relation draws,
each from a fresh seed (from ``os.urandom``, printed so that a draw can be
replayed): the kernel path's gradients against the plain path's under
``torch.use_deterministic_algorithms``, each draw's largest share of the
test's tolerance, and, for every draw, the two paths' training forwards
compared module by module (forward hooks: each module call's largest
difference over its output's largest entry, and the elements that are
exactly 0 on one path only, a ReLU that a near tie flips); prints the
shares' quantiles, every failing draw with its seed, its worst parameters
and its forward comparison, and the same comparison summed over the
passing draws; ``--save DIR`` also writes each failing draw's relation
tensors there.

    python tests/rearev_v2_grad_noise.py --draws 300 --save build/draws

With ``--replay SEED ..`` it runs the test's body on those draws again and
prints, for each ``e2e_linear{s}.bias`` (the gradients that failed), the
largest plain gradient, the kernel path's largest distance from it, its
share of the test's tolerance and the size of the sum behind the
gradient: each bias gradient is the sum, over the batch's rows and the
layer's calls, of the gradient at the layer's output, so the largest
per-feature sum of those terms' sizes (backward hooks) over the largest
gradient says how far the sum cancels, and the distance over 2^-24 times
that size counts it in float roundings of the terms; and, for each call
of the layer, the two paths' output gradients compared: the largest
distance over the largest entry, the (batch, entity) row where it lies,
how many rows differ by more than 1e-3 of the largest entry, and the
elements of the layer's output (its ReLU's input) whose sign differs
between the two paths, each with its (batch, entity, feature) and its
value on both.

    python tests/rearev_v2_grad_noise.py --replay 134763879503922

Needs an NVIDIA GPU; imports no JAX.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
os.environ["GNN_RAG_GATE_SCATTER"] = "v2"

import torch  # noqa: E402

import test_torch_cuda as tc  # noqa: E402
from gnn_rag_tpu_torch.ops import gate_scatter as gs  # noqa: E402

KERNELS = ("fused_gate_scatter_fwd", "fused_gate_scatter_bwd",
           "gate_scatter_fwd", "gate_scatter_bwd")
# gradients that are 0 up to rounding; the test holds them to |g| <= 1e-5
SOFTMAX_BIASES = ("reasoning.score_func.bias",
                  "instruction_decoder.ca_linear.bias")
RUNS = 5


def grads(model, batch, rel, plain, deterministic):
    real = {name: getattr(gs, name) for name in KERNELS}
    if plain:
        for name in KERNELS:
            setattr(gs, name, getattr(gs, name + "_plain"))
    torch.use_deterministic_algorithms(deterministic)
    try:
        model.zero_grad(set_to_none=True)
        model(batch, *rel, training=True)[0].backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}
    finally:
        torch.use_deterministic_algorithms(False)
        for name, f in real.items():
            setattr(gs, name, f)


def moved(a, b):
    return {k: (a[k] - b[k]).abs().max().item() for k in a
            if not torch.equal(a[k], b[k])}


def worst(got, want):
    return sorted(((got[n] - w).abs().max().item()
                   / (1e-4 * w.abs().max().item() + 1e-7), n)
                  for n, w in want.items() if n not in SOFTMAX_BIASES)[-3:]


def forwards(model, batch, rel):
    """The kernel path's and the plain path's training forwards, module
    call by module call: {"module#call": (largest |difference| over
    largest |plain|, elements 0 on one path only)} for every call whose
    outputs differ."""
    seen = []

    def hook(mod, args, out):
        outs = out if isinstance(out, tuple) else (out,)
        seen[-1].append((names[mod], [o.detach().clone() for o in outs
                                      if isinstance(o, torch.Tensor)
                                      and o.is_floating_point()]))

    names = {m: n or "model" for n, m in model.named_modules()}
    handles = [m.register_forward_hook(hook) for m in names]
    try:
        for plain in (False, True):
            seen.append([])
            real = {name: getattr(gs, name) for name in KERNELS}
            if plain:
                for name in KERNELS:
                    setattr(gs, name, getattr(gs, name + "_plain"))
            torch.use_deterministic_algorithms(plain)
            try:
                with torch.no_grad():
                    model(batch, *rel, training=True)
            finally:
                torch.use_deterministic_algorithms(False)
                for name, f in real.items():
                    setattr(gs, name, f)
    finally:
        for h in handles:
            h.remove()
    out, calls = {}, {}
    for (name, a), (_, b) in zip(*seen):
        calls[name] = calls.get(name, -1) + 1
        for x, y in zip(a, b):
            if x.shape != y.shape or torch.equal(x, y):
                continue
            rel_diff = ((x - y).abs().max() / y.abs().max().clamp_min(
                1e-30)).item()
            flips = int(((x == 0) != (y == 0)).sum())
            key = f"{name}#{calls[name]}"
            old = out.get(key, (0.0, 0))
            out[key] = (max(old[0], rel_diff), old[1] + flips)
    return out


def replay(seeds, device):
    """The bias gradients of the draws of ``seeds`` (above)."""
    for seed in seeds:
        torch.manual_seed(seed)
        model, batch, rel = tc.model_batch(device, "float32")
        linears = {n: m for n, m in model.named_modules()
                   if n.split(".")[-1].startswith("e2e_linear")}
        sizes, outs, zs = {}, {}, {}

        def keep(name):
            def fn(mod, args, out):
                zs.setdefault(name, []).append(out.detach().clone())
            return fn

        def hook(name):
            def fn(mod, grad_in, grad_out):
                g = grad_out[0].detach()
                sizes[name] = sizes.get(name, 0) + g.abs().flatten(
                    0, -2).sum(0)
                outs.setdefault(name, []).append(g.clone())
            return fn

        handles = [m.register_full_backward_hook(hook(n))
                   for n, m in linears.items()]
        handles += [m.register_forward_hook(keep(n))
                    for n, m in linears.items()]
        try:
            got = grads(model, batch, rel, False, False)
            got_sizes, got_outs, got_zs = sizes, outs, zs
            sizes, outs, zs = {}, {}, {}
            want = grads(model, batch, rel, True, True)
        finally:
            for h in handles:
                h.remove()
        rows = {}
        for n in linears:
            w, g = want[n + ".bias"], got[n + ".bias"]
            err = (g - w).abs().max().item()
            size = torch.maximum(got_sizes[n], sizes[n]).max().item()
            big = w.abs().max().item()
            rows[n + ".bias"] = dict(
                max_plain=big, err=err, share=err / (1e-4 * big + 1e-7),
                terms_size=size, cancels=size / max(big, 1e-30),
                err_in_roundings=err / (2.0 ** -24 * size), calls=[])
            for a, b in zip(got_outs[n], outs[n]):   # backward: last first
                d = (a - b).abs().amax(-1)                  # [B, E]
                top = b.abs().max().item()
                at = divmod(int(d.argmax()), d.shape[-1])
                rows[n + ".bias"]["calls"].append(dict(
                    rel=d.max().item() / max(top, 1e-30), at=at,
                    rows_off=int((d > 1e-3 * top).sum())))
            rows[n + ".bias"]["sign_flips"] = [
                [dict(at=[int(i) for i in idx], kernel=a[tuple(idx)].item(),
                      plain=b[tuple(idx)].item())
                 for idx in ((a > 0) != (b > 0)).nonzero()[:4]]
                for a, b in zip(got_zs[n], zs[n])]
        print(json.dumps(dict(seed=seed, biases=rows)), flush=True)


def draws(n, save, device):
    """The test's body over n relation draws (above)."""
    shares, failing, passing_flips = [], [], {}
    for i in range(n):
        seed = int.from_bytes(os.urandom(6), "little")
        torch.manual_seed(seed)
        model, batch, rel = tc.model_batch(device, "float32")
        got = grads(model, batch, rel, False, False)
        want = grads(model, batch, rel, True, True)
        top = worst(got, want)
        biases = max(max(got[b].abs().max().item(), want[b].abs().max().item())
                     for b in SOFTMAX_BIASES)
        fwd = forwards(model, batch, rel)
        shares.append(top[-1][0])
        if top[-1][0] > 1 or biases > 1e-5:
            failing.append(dict(draw=i, seed=seed, worst=top,
                                softmax_bias_max=biases,
                                flips={k: v for k, v in fwd.items() if v[1]},
                                largest=sorted(fwd.items(),
                                               key=lambda kv: -kv[1][0])[:8]))
            if save:
                os.makedirs(save, exist_ok=True)
                torch.save(dict(seed=seed, rel=[r.cpu() for r in rel]),
                           os.path.join(save, f"draw{i}.pt"))
        else:
            for k, (_, f) in fwd.items():
                if f:
                    passing_flips[k] = passing_flips.get(k, 0) + 1
    q = sorted(shares)
    print(json.dumps(dict(
        draws=n, failing=len(failing),
        share_quantiles={p: q[min(len(q) - 1, int(p * len(q)))]
                         for p in (0.5, 0.9, 0.99, 1.0)},
        passing_draws_with_flips_by_module=passing_flips,
        failing_draws=failing)), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("rearev_v2_grad_noise: needs an NVIDIA GPU")
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=0)
    ap.add_argument("--save", default=None)
    ap.add_argument("--replay", type=int, nargs="*", default=())
    args = ap.parse_args()
    device = torch.device("cuda")
    if args.replay:
        return replay(args.replay, device)
    if args.draws:
        return draws(args.draws, args.save, device)
    torch.manual_seed(0)
    model, batch, rel = tc.model_batch(device, "float32")
    for deterministic in (False, True):
        plain = [grads(model, batch, rel, True, deterministic)
                 for _ in range(RUNS)]
        kernel = [grads(model, batch, rel, False, deterministic)
                  for _ in range(RUNS)]
        print(json.dumps(dict(
            deterministic=deterministic,
            plain_moved_from_first_run=[moved(plain[0], g) for g in plain[1:]],
            kernel_moved_from_first_run=[moved(kernel[0], g)
                                         for g in kernel[1:]],
            kernel_vs_plain_over_tolerance=[worst(k, p) for k, p
                                            in zip(kernel, plain)])),
              flush=True)


if __name__ == "__main__":
    main()
