"""gnn_rag_tpu_torch — the GNN-RAG retriever in PyTorch for an NVIDIA H100,
serving and training, beside the JAX reference package ``gnn_rag_tpu``.

Serving: question JSON -> ingest + tile-sorted kernel layout (``data``) ->
frozen question/relation LM (``models.frozen_lm``) -> ReaRev forward
(``models.rearev``) whose message passing runs the hand-written gate-scatter
CUDA kernel (``ops.gate_scatter``, ``csrc/gate_scatter.cu``) ->
eps-cumulative candidates and the `.info` export (``train.evaluate``) ->
verbalized shortest paths (``serve``).

Training: ``python -m gnn_rag_tpu_torch ReaRev <flags>`` (``cli``) ->
``train.trainer`` (ReaRev in training mode with dropout and fact dropout,
the gate-scatter gradient in its backward CUDA kernel, global-norm clip,
Adam with staircase decay, on-device metrics, checkpoints in
``utils.checkpoint``). ``bridge`` carries flax parameter trees across, so
every module and gradient is held against its JAX counterpart.

The package imports torch and never jax, flax, optax or orbax.
"""

import torch

# fp32 parity with the JAX package, whose kernels take IEEE fp32 products
# (Precision.HIGHEST): no TF32 in matmuls or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.2.0"
