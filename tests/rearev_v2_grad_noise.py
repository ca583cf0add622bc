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

Needs an NVIDIA GPU; imports no JAX.
"""

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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("rearev_v2_grad_noise: needs an NVIDIA GPU")
    device = torch.device("cuda")
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
