"""Causal flash attention for Hopper: forward, dq and dk/dv kernels.

Replaces the TPU kernels of gnn_rag_tpu/llm_tpu/flash_attention.py:
``_flash_kernel`` (:47, forward: o and the row logsumexp), ``_dq_kernel``
(:132) and ``_dkv_kernel`` (:170). The CUDA source is
``csrc/flash_attention.cu`` (with the Hopper building blocks of
``csrc/sm90.cuh``); its header says how the blocks are laid out and what
bounds them on an H100.

Contract (the JAX package's): q ``[B, L, H, D]``, k and v ``[B, S, H, D]``
with the kv heads already repeated to H (GQA), causal mask key <= query,
scale 1/sqrt(D), masked scores -1e30. ``flash_fwd`` returns o (q's type) and
lse ``[B*H, L]`` float32, with p rounded to v's type before it multiplies v;
``flash_dq`` and ``flash_dkv`` recompute p per block from (q, k, lse) and
work in float32 from the widened inputs, given delta = rowsum(dO * o)
``[B*H, L]`` (a plain reduction, ``bwd_delta``, as the JAX package leaves it
to XLA). bfloat16 and float16 inputs run on the tensor cores through TMA
and wgmma (the backward's float p and ds as two 16-bit terms, hi + mid:
bf16 within 2^-16 of each product; float16 within 2^-22, after exact
power-of-two scales that keep small p and ds inside float16's range: p by
2^14, ds by a scale per accumulator row chosen from the data, undone at
the store). float32 inputs run all three kernels on the tensor cores too,
each float as three bf16 terms and each product as six bf16 products
(within ~2^-23 of it: the TPU's float32 dots at Precision.HIGHEST do the
same); all sums are float. The kernels take head dim D a multiple of
128, up to 2304 in float32 and up to 4096 in bfloat16 and float16
(``HEAD_DIMS``): the 16-bit ones from 384 split the depth over a cluster
of NB = ceil(D / 256) blocks, each on a share of whole 64-column boxes of
at most 256 columns, the shares differing by at most one box
(``cluster16_shares``: 2 x 192 at 384, 256 + 192 + 192 at 640, 7 x 256 +
2 x 192 at 2176, 16 x 256 at 4096); the float32 ones from 256 to 2048
over a cluster of D / 128 blocks, each on 128 columns, and at 2176 and
2304 over twelve blocks on shares of whole boxes of at most 192 columns
(``split3_shares``: 10 x 192 + 2 x 128 at 2176, 12 x 192 at 2304). All
stop at Hopper's largest cluster, 16 blocks (past 8 its non-portable
sizes). A cluster's
partial scores are added once (two blocks) or in rank order (three to
sixteen, every block adding the same operands in the same order, so that
all hold the same bits). The scale 1/sqrt(D) is exact at 128 and 256
(1/16 there); elsewhere it is the float nearest it, as in the JAX
kernels. Any L and S (a ragged last tile is masked in the kernel; the JAX
wrapper pads L to 128 instead). The JAX model sends every D % 128 == 0 in
any type to its Pallas kernels, but their block specs hold whole ``[128,
D]`` rows in the TPU's scoped memory (k, v, q and dO double-buffered and
two float scratch blocks, about 14 x 512 x D bytes in float32 against
16 MB: about 2,304 is their float32 ceiling, an estimate from the code);
float32 past 2304 and 16-bit head dims past 4096 raise here, and
``llm.model.flash_applies`` sends them to plain attention.

Dispatch: CPU tensors take the plain versions (``flash_fwd_plain``,
``flash_dq_plain``, ``flash_dkv_plain``: dense attention and the
lse-recompute backward, same arithmetic, in float32; in float64 for
float64 inputs, where p is not rounded either: the exact function, a
yardstick free of float noise); CUDA tensors launch the kernels or raise.
``FlashAttentionFn`` is the autograd op; ``flash_attention`` its entry.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..utils import build as _build

NEG_INF = -1e30
# the head dims the kernels take, by input type (any other shape or type
# raises; ``llm.model.flash_applies`` sends those to plain attention):
# float32 in clusters of up to sixteen 128-column blocks, and at 2176 and
# 2304 of twelve blocks of up to 192 columns; bfloat16 and float16 from
# 384 in clusters of two to sixteen blocks of up to 256 columns
HEAD_DIMS = {torch.float32: tuple(range(128, 2305, 128)),
             **dict.fromkeys((torch.bfloat16, torch.float16),
                             tuple(range(128, 4097, 128)))}
# the C entry points' element type code
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}



def cluster16_shares(D):
    """The columns of each block of a 16-bit cluster at head dim D (384 to
    4096), rank by rank: D / 64 boxes over ceil(D / 256) blocks (2 to 16),
    the shares differing by at most one box, the wider first
    (``share16_units`` in ``csrc/flash_attention.cu``)."""
    boxes, nb = D // 64, -(-D // 256)
    return [64 * (boxes // nb + (r < boxes % nb)) for r in range(nb)]


def split3_shares(D):
    """The columns of each block of a float32 cluster on shares of at most
    192 columns at head dim D (the kernels' plan at 2176 and 2304), rank by
    rank: D / 64 boxes over ceil(D / 192) blocks, the shares differing by
    at most one box, the wider first (``share3_units`` in
    ``csrc/flash_attention.cu``)."""
    boxes, nb = D // 64, -(-D // 192)
    return [64 * (boxes // nb + (r < boxes % nb)) for r in range(nb)]


# The exchange of the 16-bit cluster forward and the float32 forward, dq
# and dk/dv from head dim 640 (``reduce_scatter_partials`` in
# ``csrc/flash_attention.cu``; the 16-bit dq and dk/dv, the float32
# 192-column shares and the float32 head dims 384 and 512 keep the
# all-gather): a
# warpgroup's 32 floats a thread as float4 groups, float4 i of thread t
# group 128 i + t, cut into one contiguous slice a block of the cluster;
# each block adds its slice's groups from every block's partial in rank
# order and every block reads each group back from its owner
EXCHANGE_GROUPS = 8 * 128


def exchange_slices(nb):
    """The groups ``[first, end)`` that each block of a cluster of nb
    blocks sums, rank by rank: EXCHANGE_GROUPS / nb, rounded down or up
    (``xchg_slice0``)."""
    return [(r * EXCHANGE_GROUPS // nb, (r + 1) * EXCHANGE_GROUPS // nb)
            for r in range(nb)]


def exchange_owner(nb, g):
    """The block of a cluster of nb blocks whose slice holds group g
    (``xchg_owner``)."""
    return ((g + 1) * nb - 1) // EXCHANGE_GROUPS


# launches of the CUDA kernels (plain-version calls are not counted)
fwd_launches = 0      # flash_fwd
dq_launches = 0       # flash_dq
dkv_launches = 0      # flash_dkv

_lib = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile ``csrc/flash_attention.cu`` into ``build/gnn_rag_tpu_torch/``
    unless that library exists; returns its path."""
    return _build.library("flash_attention.cu")


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            tail = [i32] * 5 + [ctypes.c_float, i32, ptr]
            lib.flash_attention_fwd.argtypes = [ptr] * 5 + tail
            lib.flash_attention_dq.argtypes = [ptr] * 7 + tail
            lib.flash_attention_dkv.argtypes = [ptr] * 8 + tail
            for fn in (lib.flash_attention_fwd, lib.flash_attention_dq,
                       lib.flash_attention_dkv):
                fn.restype = i32
            lib.flash_attention_max_clusters.argtypes = [i32, i32, i32, ptr]
            lib.flash_attention_max_clusters.restype = i32
            lib.flash_attention_error_string.argtypes = [i32]
            lib.flash_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


# ------------------------------------------------------------ plain versions
def _wide(x):
    """x in the plain versions' arithmetic: float32, float64 if x is."""
    return x if x.dtype == torch.float64 else x.float()


def _scores(q, k):
    """Masked, scaled float32 (float64) scores ``[B, H, L, S]``."""
    L, S, D = q.shape[1], k.shape[1], q.shape[3]
    s = torch.einsum("blhd,bshd->bhls", _wide(q), _wide(k)) * (1.0 / D ** 0.5)
    keep = (torch.arange(S, device=q.device)[None, :]
            <= torch.arange(L, device=q.device)[:, None])
    return s.masked_fill(~keep, NEG_INF)


def flash_fwd_plain(q, k, v):
    """Dense causal attention -> (o ``[B, L, H, D]`` in q's type, lse
    ``[B*H, L]`` float32; float64 for float64 inputs), the kernel's
    arithmetic in two passes."""
    B, L, H, _ = q.shape
    s = _scores(q, k)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhls,bshd->bhld", _wide(p.to(v.dtype)), _wide(v)) / l
    lse = (m + torch.log(l)).reshape(B * H, L)
    return o.transpose(1, 2).to(q.dtype), lse


def _probs(q, k, lse):
    B, L, H, _ = q.shape
    return torch.exp(_scores(q, k) - lse.reshape(B, H, L, 1))


def _dscores(q, k, v, dout, lse, delta):
    B, L, H, D = q.shape
    p = _probs(q, k, lse)
    dp = torch.einsum("blhd,bshd->bhls", _wide(dout), _wide(v))
    return p, p * (dp - delta.reshape(B, H, L, 1)) * (1.0 / D ** 0.5)


def flash_dq_plain(q, k, v, dout, lse, delta):
    """dq of the lse-recompute backward, float32 arithmetic (float64 for
    float64 inputs), q's type."""
    _, ds = _dscores(q, k, v, dout, lse, delta)
    return torch.einsum("bhls,bshd->blhd", ds, _wide(k)).to(q.dtype)


def flash_dkv_plain(q, k, v, dout, lse, delta):
    """(dk, dv) of the lse-recompute backward, float32 arithmetic (float64
    for float64 inputs)."""
    p, ds = _dscores(q, k, v, dout, lse, delta)
    dk = torch.einsum("bhls,blhd->bshd", ds, _wide(q))
    dv = torch.einsum("bhls,blhd->bshd", p, _wide(dout))
    return dk.to(k.dtype), dv.to(v.dtype)


def bwd_delta(o, dout):
    """delta = rowsum(dO * o) in float32, ``[B*H, L]``."""
    B, L, H, _ = o.shape
    return (dout.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * H, L
                                                                      ).contiguous()


# ------------------------------------------------------------------ kernels
def _check(q, k, v, *more):
    B, L, H, D = q.shape
    if D not in HEAD_DIMS.get(q.dtype, ()):
        raise ValueError(f"flash_attention: the kernels take head dim 128, "
                         f"256, .. (a multiple of 128) up to 2304 in "
                         f"float32 and up to 4096 in bfloat16 or float16, "
                         f"got {tuple(q.shape)} {q.dtype}")
    S = k.shape[1]
    for name, t, shape in (("k", k, (B, S, H, D)), ("v", v, (B, S, H, D)),
                           *more):
        dtype = torch.float32 if name in ("lse", "delta") else q.dtype
        if (t.shape != shape or t.dtype != dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"{dtype} {shape} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not q.is_contiguous():
        raise ValueError("flash_attention: q must be contiguous")
    heads = (q, k, v, *(t for name, t, _ in more if name == "dout"))
    if any(t.data_ptr() % 16 for t in heads):
        raise ValueError("flash_attention: q, k, v and dout must be 16-byte "
                         "aligned")
    return B, L, H, D, S


def _raise(lib, err, what):
    if err != 0:
        raise RuntimeError(f"flash_attention {what} launch failed: "
                           + lib.flash_attention_error_string(err).decode())


def _device_ok(q):
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return True


def max_active_clusters(kind, D, dtype=torch.float32):
    """How many clusters of the kernel ``kind`` ("fwd", "dq" or "dkv") of
    ``dtype`` at head dim ``D`` the current card holds at once
    (cudaOccupancyMaxActiveClusters): float32 at any of its ``HEAD_DIMS``
    (clusters of D / 128 blocks, one block at 128; ceil(D / 192) at 2176 and
    2304), bfloat16 and float16 at
    384 to 4096 (clusters of ceil(D / 256) blocks, two to sixteen); 0 means
    it cannot launch one. Raises on another kind, type or D."""
    lib = _load()
    n = ctypes.c_int(0)
    err = lib.flash_attention_max_clusters(("fwd", "dq", "dkv").index(kind),
                                           D, _DTYPE_CODE[dtype],
                                           ctypes.byref(n))
    _raise(lib, err, f"{kind} cluster occupancy")
    return n.value


def flash_fwd(q, k, v):
    """Forward: (o, lse). CPU tensors run the plain version; CUDA tensors
    launch the kernel (K5a) on the current stream or raise."""
    global fwd_launches
    if not _device_ok(q):
        return flash_fwd_plain(q, k, v)
    B, L, H, D, S = _check(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B * H, L), dtype=torch.float32, device=q.device)
    lib = _load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, L, S, D, 1.0 / math.sqrt(D),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    _raise(lib, err, "forward")
    fwd_launches += 1
    return o, lse


def flash_dq(q, k, v, dout, lse, delta):
    """dq (K5b). CPU: plain version; CUDA: the kernel or raise."""
    global dq_launches
    if not _device_ok(q):
        return flash_dq_plain(q, k, v, dout, lse, delta)
    B, L, H, D, S = _check(q, k, v, ("dout", dout, q.shape),
                           ("lse", lse, (q.shape[0] * q.shape[2], q.shape[1])),
                           ("delta", delta, (q.shape[0] * q.shape[2], q.shape[1])))
    dq = torch.empty_like(q)
    lib = _load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, L, S, D,
            1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _raise(lib, err, "dq")
    dq_launches += 1
    return dq


def flash_dkv(q, k, v, dout, lse, delta):
    """(dk, dv) (K5c). CPU: plain version; CUDA: the kernel or raise."""
    global dkv_launches
    if not _device_ok(q):
        return flash_dkv_plain(q, k, v, dout, lse, delta)
    B, L, H, D, S = _check(q, k, v, ("dout", dout, q.shape),
                           ("lse", lse, (q.shape[0] * q.shape[2], q.shape[1])),
                           ("delta", delta, (q.shape[0] * q.shape[2], q.shape[1])))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, L, S, D, 1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _raise(lib, err, "dkv")
    dkv_launches += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, dout):
    """(dq, dk, dv) of ``flash_attention`` for the cotangent ``dout``."""
    delta = bwd_delta(o, dout)
    return (flash_dq(q, k, v, dout, lse, delta),
            *flash_dkv(q, k, v, dout, lse, delta))


class FlashAttentionFn(torch.autograd.Function):
    """``flash_fwd`` with ``flash_bwd`` as its gradient. Both are looked up
    in this module at call time, so swapping ``flash_fwd``, ``flash_dq`` and
    ``flash_dkv`` for their plain versions runs a model through those."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, dout):
        return flash_bwd(*ctx.saved_tensors, dout.contiguous())


def flash_attention(q, k, v):
    """Causal attention; q ``[B, L, H, D]``, k/v ``[B, S, H, D]`` (heads
    already GQA-expanded), differentiable through ``FlashAttentionFn``."""
    return FlashAttentionFn.apply(q.contiguous(), k.contiguous(), v.contiguous())
