"""gnn_rag_tpu_torch — GNN-RAG in PyTorch for an NVIDIA H100: the retriever
(serving and training) and the LLM reader's SFT, beside the JAX reference
package ``gnn_rag_tpu``.

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

The LLM reader: ``python -m gnn_rag_tpu_torch.llm.sft`` (``llm.sft``) trains
``llm.model.LlamaLM`` with completion-only loss on ``finetune.data_prep``
texts; its attention runs the hand-written flash-attention CUDA kernels
forward and backward (``llm.flash_attention``, ``csrc/flash_attention.cu``);
``llm.generate.Decoder`` decodes greedily with a kv cache.

The package imports torch and never jax, flax, optax, orbax or a module of
``gnn_rag_tpu``: the framework-free modules it needs are copies of its own.
"""

import torch

# fp32 parity with the JAX package, whose kernels take IEEE fp32 products
# (Precision.HIGHEST): no TF32 in matmuls or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.2.0"
