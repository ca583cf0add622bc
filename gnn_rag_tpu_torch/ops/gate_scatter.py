"""Gate-scatter: the message-passing kernel of ReaRev, for Hopper.

For each direction d, sample b and fact slot f of the tile-sorted layout:

    out[d, b, scatter[d,b,f], j*D:(j+1)*D] +=
        act(vals[d,b,f] * ins[b,j]) * prior[d,b,f]

with ``act`` = relu (or identity for TypeLayer), pad slots (``scatter < 0``)
adding nothing, and the output j-major ``[ndir, B, E, J*D]`` in float32.

Replaces the TPU kernels ``_fused_kernel_v4`` (gnn_rag_tpu/ops/pallas_mp.py:
844, both directions in one launch), ``_fused_kernel_v4s`` (:1231, the
per-direction / per-instruction tiers for large E) and ``_fused_kernel_v3``
(:565, one direction, ``[B, J, E, D]`` output). On the TPU the three exist
because the resident output block must fit a scoped-VMEM budget; on the GPU
one kernel (``csrc/gate_scatter.cu``) covers every E and every width, by
column windows: a 128-entity tile's rows are summed in shared memory, so
there is no size tier to dispatch on, and where a block cannot hold the
tile at J*D columns it takes a window of D's columns for all J instructions
(the gate is elementwise in the column), one more grid dimension of the
same launch. Each kernel's library entry reports the widest window that
fits a block, from the shared-memory layout its launch uses, and
``window_plan`` cuts D into windows of at most that width before the
launch (``kernel_window``); today's widths take one window.

What bounds it on an H100: it reads B*Fp*D input values per direction and
writes B*E*J*D floats, with one multiply-add per (fact, column), so it is
bound by memory traffic and load latency, not arithmetic. The design keeps
the J*D products out of device memory (the plain version below materialises
a [ndir, B, Fp, J*D] float tensor and scatters it with atomics) and needs no
atomics, so its sums are deterministic. A tile's chunk range is split over
up to 8 blocks of at least 4 chunks, so the few long tiles of a skewed
subgraph do not set the time: a tile of one part writes its rows directly,
the parts of a longer tile write partial tiles to a workspace that a second
small kernel adds in part order. Each block streams its slots 32 at a time
through a ring of shared-memory stages (asynchronous copies, the next
stages in flight while one computes), and every thread of the block runs
the gate: thread (group, column) adds the slots whose row falls to its
group.

Numerics follow the TPU kernel (pallas_mp.py:872-889): ``vals * ins`` is
formed in the input type, ``prior`` is rounded to the input type before it
multiplies, and products are summed in float32.

The backward (``gate_scatter_bwd``, same CUDA source) replaces the TPU
kernels ``_fused_bwd_kernel_v4`` (pallas_mp.py:988), ``_fused_bwd_kernel_v4s``
(:1267) and ``_fused_bwd_kernel_v3`` (:639). With ``gb = g[d, b,
scatter[f], :]`` and ``pre = vals[f] * ins_j`` in float32 it returns
``dprior[f] = sum gb * act(pre)``, ``dvals[f] = sum_j gb_j * prior[f] *
1[pre_j > 0] * ins_j`` and ``dins[b, j] = sum_f (...) * vals[f]``, summed in
float32 with the prior unrounded (the TPU backward reads the prior in f32,
pallas_mp.py:1018, although its forward rounds it). It is bound by memory
traffic and load latency: per direction it reads the [B, E, J*D] cotangent
once, as whole-tile shared-memory copies, and the [B, Fp, D] values. So
that no slot waits on a dependent load from device memory, each block
streams its slots 64 at a time through a ring of shared-memory stages
(values, scatter and prior by asynchronous copies, the next stages in
flight while one computes); half a warp takes a slot, writes its dvals row
once and reduces its dprior with shuffles; a tile's chunk range is split
over up to 8 blocks, so the few long tiles of a skewed subgraph do not set
the time; dins goes through per-part partials summed in a fixed order
(direction, tile, part), so no float atomics and a repeatable sum.

``GateScatterFn`` is the autograd op: its forward is ``gate_scatter_fwd`` and
its backward ``gate_scatter_bwd``; ``gate_scatter_both`` and
``gate_scatter_projected`` go through it.

The fused-projection op (``gate_scatter``, one direction per call, what
ReaRev runs under ``GNN_RAG_GATE_SCATTER`` other than v3/v4) takes the
relation features of each fact slot before ``rel_linear`` and projects them
in the kernel: ``rl = T(float(fact_rel @ w) + float(b))``, then the gate
above on ``rl``. ``fused_gate_scatter_fwd`` replaces the TPU kernels
``_fused_kernel`` (pallas_mp.py:126, v1) and ``_fused_kernel_v2`` (:210), which
compute the same function on two schedules; ``fused_gate_scatter_bwd``
replaces ``_fused_bwd_kernel`` (:316): it recomputes ``rl`` in float32
without rounding it, reads the prior unrounded, and returns ``dfact_rel``,
``dw``, ``dbias``, ``dins`` and ``dprior``, ``dw`` and ``dbias`` summed over
every block in a fixed order (no float atomics). ``FusedGateScatterFn`` is
its autograd op. The forward adds 2*D*D flops per fact slot to the gate's
bytes, so at D 50 in float32 its bytes and its operations take about the
same least time; the backward adds 6*D*D and is bound by operations. In
both, the D x D products are register-tiled SIMT GEMMs over shared memory
(a 4 x 4 tile a thread from float4 loads), the next stage's rows load
while one computes, and a tile's chunk range is split over several blocks
whose partials are added in a fixed order: the forward's partial output
tiles by a second small kernel (a tile of one part writes its rows
directly), the backward's dins and dW/db partials. Every thread of the
forward's block runs its gate loop: thread (group, column) adds the slots
whose row falls to its group.

``scatter_mm`` (values ``[B, Fp, C]`` -> ``[B, E, C]`` float32, a plain
scatter-add over the same layout, found by ``chunk_tiles``) replaces
``_scatter_kernel`` (pallas_mp.py:32); its gradient is a gather, as in JAX
(:103-108). No model calls it.

Dispatch: CPU tensors take the plain versions (``*_plain``); CUDA tensors
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..data.kernel_layout import TILE_E, TILE_F
from ..utils import build as _build
from .segment import batched_segment_sum

# launches of the CUDA kernels (plain-version calls are not counted)
launches = 0            # gate_scatter_fwd
bwd_launches = 0        # gate_scatter_bwd
launches_1dir = 0       # the gate_scatter_fwd launches of one direction
bwd_launches_1dir = 0   # the gate_scatter_bwd launches of one direction
fused_launches = 0      # fused_gate_scatter_fwd
fused_bwd_launches = 0  # fused_gate_scatter_bwd
scatter_launches = 0    # scatter_mm_fwd

_lib = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile ``csrc/gate_scatter.cu`` into ``build/gnn_rag_tpu_torch/``
    unless that library exists; returns its path."""
    return _build.library("gate_scatter.cu")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            # (name, pointers, ints, pointers after the ints: the raw
            # workspace (the forward's split tiles, the backward's window
            # partials), then the stream)
            for name, n_ptr, n_int, n_last in (
                    ("gate_scatter_fwd", 10, 9, 2),
                    ("gate_scatter_bwd", 14, 9, 2),
                    ("fused_gate_scatter_fwd", 9, 8, 1),
                    ("fused_gate_scatter_bwd", 15, 8, 2),
                    ("scatter_mm_fwd", 4, 6, 2)):
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                               + [ctypes.c_void_p] * n_last)
                fn.restype = ctypes.c_int
            lib.gate_scatter_parts.argtypes = []
            lib.gate_scatter_parts.restype = ctypes.c_int
            for name in ("gate_scatter_fwd_slots", "fused_gate_scatter_fwd_slots"):
                getattr(lib, name).argtypes = [ctypes.c_int]
                getattr(lib, name).restype = ctypes.c_int
            for name in set(_WINDOW_ENTRY.values()):
                getattr(lib, name).argtypes = [ctypes.c_int] * 3
                getattr(lib, name).restype = ctypes.c_int
            lib.gate_scatter_error_string.argtypes = [ctypes.c_int]
            lib.gate_scatter_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


# ------------------------------------------------------------ column windows
# each kernel's entry in the library reporting the widest window that fits
_WINDOW_ENTRY = {"gate_scatter_fwd": "gate_scatter_fwd_window",
                 "scatter_mm_fwd": "gate_scatter_fwd_window",
                 "gate_scatter_bwd": "gate_scatter_bwd_window",
                 "fused_gate_scatter_fwd": "fused_gate_scatter_fwd_window",
                 "fused_gate_scatter_bwd": "fused_gate_scatter_bwd_window"}
_plans: dict = {}


def window_plan(D: int, widest: int, itemsize: int) -> tuple[int, int]:
    """The column windows of a launch at width ``D`` when no window wider
    than ``widest`` fits one block: ``(W, n)``, window i holding columns
    ``i*W .. min((i+1)*W, D) - 1``. One window (``W = D``)
    where ``D`` fits. Otherwise the windows are as equal as the 16-byte
    copy allows: ``W`` a multiple of ``16 // itemsize`` values (4 floats or
    8 bf16), so every window starts on a copy, the last one taking the
    remainder; below one copy's width (a huge J), any ``W <= widest``.
    ``widest < 1`` (no window fits) raises."""
    if widest >= D:
        return D, 1
    if widest < 1:
        raise ValueError(f"gate_scatter: no column window of D={D} fits one "
                         f"block's shared memory")
    align = 16 // itemsize
    cap = widest - widest % align if widest >= align else widest
    W = -(-D // -(-D // cap))            # equal windows of at most cap
    if cap % align == 0:
        W = -(-W // align) * align       # rounded up to a copy: still <= cap
    return W, -(-D // W)


def kernel_window(name: str, D: int, J: int, dtype, device=None,
                  window: int | None = None) -> tuple[int, int]:
    """``(W, n)``: the column windows kernel ``name`` (a key of
    ``_WINDOW_ENTRY``) runs at width ``D`` and ``J`` instructions on the
    card, from the library's fit entry (the shared-memory layout its launch
    uses, against the device's per-block limit) through ``window_plan``;
    once per shape. ``window``: a width to run instead (1 to D), as the
    card tests do to hold the windowed path against one window."""
    if window is not None:
        if not 1 <= window <= D:
            raise ValueError(f"{name}: window {window} outside [1, {D}]")
        return window, -(-D // window)
    # once per shape; every launch looks its plan up
    key = (name, None if device is None else device.index, D, J, dtype)
    plan = _plans.get(key)
    if plan is None:
        index = torch.cuda.current_device() if device is None else device.index
        with torch.cuda.device(index):
            widest = getattr(_load(), _WINDOW_ENTRY[name])(D, J, dtype.itemsize)
        plan = _plans[key] = window_plan(D, widest, dtype.itemsize)
    return plan


def gate_scatter_fwd_plain(vals, ins: torch.Tensor, prior, scatter,
                           chunk_starts, apply_relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same contract and numerics (see
    ``gate_scatter_fwd``)."""
    J = ins.shape[1]
    E = (chunk_starts[0].shape[-1] - 1) * TILE_E
    outs = []
    for v, p, s in zip(vals, prior, scatter):
        B, Fp, D = v.shape
        g = v[:, :, None, :] * ins[:, None, :, :]              # input dtype
        if apply_relu:
            g = torch.relu(g)
        contrib = g.float().reshape(B, Fp, J * D) * p.to(v.dtype).float()[..., None]
        contrib = torch.where((s >= 0)[..., None], contrib, 0.0)
        outs.append(batched_segment_sum(contrib, s.clamp_min(0), E))
    return torch.stack(outs)


def _check(vals, ins, prior, scatter, chunk_starts):
    """Raise unless the inputs fit the kernel. Kept lean: the forward calls
    the kernel ten times and is bound by host launch time."""
    if ins.dim() != 3 or ins.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gate_scatter: ins must be [B,J,D] float32 or "
                        f"bfloat16, got {ins.dtype} {tuple(ins.shape)}")
    B, _, D = ins.shape
    Fp = vals[0].shape[1]
    dev = ins.get_device()
    if len(vals) not in (1, 2) or Fp % TILE_F:
        raise ValueError(f"gate_scatter: {len(vals)} directions (1 or 2), "
                         f"Fp={Fp} (a multiple of {TILE_F})")
    for name, ts, dtype, shape in (
            ("vals", vals, ins.dtype, (B, Fp, D)),
            ("prior", prior, torch.float32, (B, Fp)),
            ("scatter", scatter, torch.int32, (B, Fp)),
            ("chunk_starts", chunk_starts, torch.int32,
             (B, chunk_starts[0].shape[-1]))):
        if len(ts) != len(vals):
            raise ValueError(f"gate_scatter: {len(ts)} {name}, {len(vals)} vals")
        for t in ts:
            if (t.dtype != dtype or t.shape != shape or t.get_device() != dev
                    or not t.is_contiguous()):
                raise TypeError(
                    f"gate_scatter: {name} must be a contiguous {dtype} "
                    f"{shape} on {ins.device}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    for v in vals:
        if v.data_ptr() % 16:   # the kernel stages values with 16-byte copies
            raise ValueError("gate_scatter: vals is not 16-byte aligned")


def gate_scatter_fwd(vals, ins: torch.Tensor, prior, scatter, chunk_starts,
                     apply_relu: bool = True, *,
                     window: int | None = None) -> torch.Tensor:
    """One or two directions in one launch. ``vals``, ``prior``, ``scatter``
    and ``chunk_starts`` each hold one tensor per direction (a tuple, or a
    tensor whose first axis is the direction): ``[B,Fp,D]`` vals in the type
    of ``ins [B,J,D]`` (float32 or bfloat16), ``[B,Fp]`` float32 prior,
    ``[B,Fp]`` int32 scatter, ``[B,E/128+1]`` int32 chunk_starts ->
    ``[ndir,B,E,J*D]`` float32. The launch runs D's columns in the windows
    of ``kernel_window`` (``window``: their width, default the widest that
    fits a block).

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream or raise."""
    global launches, launches_1dir
    dev = ins.device
    if dev.type == "cpu":
        return gate_scatter_fwd_plain(vals, ins, prior, scatter, chunk_starts,
                                      apply_relu)
    if dev.type != "cuda":
        raise ValueError(f"gate_scatter: unsupported device {dev}")
    vals, prior, scatter, chunk_starts = (
        x.unbind(0) if isinstance(x, torch.Tensor) else x
        for x in (vals, prior, scatter, chunk_starts))
    _check(vals, ins, prior, scatter, chunk_starts)
    ndir = len(vals)
    B, Fp, D = vals[0].shape
    J = ins.shape[1]
    n_tiles = chunk_starts[0].shape[-1] - 1
    W, _ = kernel_window("gate_scatter_fwd", D, J, ins.dtype, dev, window)
    out = torch.empty((ndir, B, n_tiles * TILE_E, J * D), dtype=torch.float32,
                      device=dev)
    _launch("gate_scatter_fwd", dev,
            vals[0].data_ptr(), vals[-1].data_ptr(), ins.data_ptr(),
            prior[0].data_ptr(), prior[-1].data_ptr(), scatter[0].data_ptr(),
            scatter[-1].data_ptr(), chunk_starts[0].data_ptr(),
            chunk_starts[-1].data_ptr(), out.data_ptr(), ndir, B, Fp, D, J,
            n_tiles, int(bool(apply_relu)), int(ins.dtype == torch.bfloat16),
            W, ws_bytes=4 * ndir * B * _fwd_slots(Fp) * TILE_E * J * D)
    launches += 1
    launches_1dir += ndir == 1
    return out


_slots: dict = {}


def _fwd_slots(Fp: int) -> int:
    """Partial tiles a (direction, sample) of the forward's workspace holds
    (the library's ``gate_scatter_fwd_slots``, once per Fp)."""
    n = _slots.get(Fp)
    if n is None:
        n = _slots[Fp] = _load().gate_scatter_fwd_slots(Fp)
    return n


def _launch(name: str, device, *args, ws_bytes=None) -> None:
    """Call the library's ``name`` with ``args`` and the current stream of
    ``device`` (made the current device for the call if it is not). With
    ``ws_bytes``, a scratch workspace of that many bytes goes just before
    the stream: taken from PyTorch's caching allocator on that stream and
    given back once the launch is queued (stream-ordered, as a tensor's
    memory is); a null pointer for 0 bytes. Raise with the CUDA error if
    the launch was refused.

    The stream and the workspace come from the bindings that
    ``torch.cuda.current_stream`` and ``torch.cuda.caching_allocator_alloc``
    wrap, without the Stream object and the device switch those build on
    every call: the forward's eager call costs its host time."""
    index = device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(name, device, *args, ws_bytes=ws_bytes)
    lib = _load()
    stream = torch._C._cuda_getCurrentRawStream(index)
    fn = getattr(lib, name)
    if ws_bytes is None:
        err = fn(*args, stream)
    elif not ws_bytes:
        err = fn(*args, None, stream)
    else:
        ws = torch._C._cuda_cudaCachingAllocator_raw_alloc(ws_bytes, stream)
        try:
            err = fn(*args, ws, stream)
        finally:
            torch._C._cuda_cudaCachingAllocator_raw_delete(ws)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.gate_scatter_error_string(err).decode())


def gate_scatter_bwd_plain(vals, ins: torch.Tensor, prior, scatter,
                           chunk_starts, g: torch.Tensor,
                           apply_relu: bool = True, *, need_dprior: bool = True,
                           need_dins: bool = True):
    """Plain PyTorch version of the backward kernel, same contract and
    numerics (see ``gate_scatter_bwd``); the formulation of the JAX op's
    XLA backward (pallas_mp.py:775-791) with the kernel's float32 ``pre``."""
    J = ins.shape[1]
    insf = ins.float()
    dvals, dprior = [], []
    dins = torch.zeros(insf.shape, dtype=torch.float32, device=ins.device)
    for v, p, s, gd in zip(vals, prior, scatter, g):
        B, Fp, D = v.shape
        vf = v.float()
        gb = torch.gather(gd, 1, s.clamp_min(0).long()[..., None].expand(
            B, Fp, J * D))
        gb = torch.where((s >= 0)[..., None], gb, 0.0).reshape(B, Fp, J, D)
        pre = vf[:, :, None, :] * insf[:, None, :, :]            # [B,Fp,J,D]
        if need_dprior:
            act = torch.relu(pre) if apply_relu else pre
            dprior.append((gb * act).sum(dim=(2, 3)))
        dval = gb * p[:, :, None, None]
        if apply_relu:
            dval = torch.where(pre > 0, dval, 0.0)
        dvals.append(torch.einsum("bfjd,bjd->bfd", dval, insf).to(v.dtype))
        if need_dins:
            dins += torch.einsum("bfjd,bfd->bjd", dval, vf)
    return (tuple(dvals), tuple(dprior) if need_dprior else None,
            dins.to(ins.dtype) if need_dins else None)


def gate_scatter_bwd(vals, ins: torch.Tensor, prior, scatter, chunk_starts,
                     g: torch.Tensor, apply_relu: bool = True, *,
                     need_dprior: bool = True, need_dins: bool = True,
                     window: int | None = None):
    """Backward of ``gate_scatter_fwd`` for the same inputs and the
    ``[ndir,B,E,J*D]`` float32 cotangent ``g`` of its output -> ``(dvals,
    dprior, dins)``: ``dvals`` one ``[B,Fp,D]`` tensor per direction in the
    type of vals, ``dprior`` one ``[B,Fp]`` float32 tensor per direction (or
    None without ``need_dprior``), ``dins`` ``[B,J,D]`` in the type of ins,
    summed over the directions (or None without ``need_dins``). Pad slots
    get zero gradients. Columns run in windows as in ``gate_scatter_fwd``;
    over several windows each writes a float partial of dprior (a sum over
    every column), added in window order by a second small kernel.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream or raise."""
    global bwd_launches, bwd_launches_1dir
    if ins.device.type == "cpu":
        return gate_scatter_bwd_plain(vals, ins, prior, scatter, chunk_starts,
                                      g, apply_relu, need_dprior=need_dprior,
                                      need_dins=need_dins)
    if ins.device.type != "cuda":
        raise ValueError(f"gate_scatter: unsupported device {ins.device}")
    vals, prior, scatter, chunk_starts = (
        x.unbind(0) if isinstance(x, torch.Tensor) else x
        for x in (vals, prior, scatter, chunk_starts))
    _check(vals, ins, prior, scatter, chunk_starts)
    ndir = len(vals)
    B, Fp, D = vals[0].shape
    J = ins.shape[1]
    n_tiles = chunk_starts[0].shape[-1] - 1
    shape = (ndir, B, n_tiles * TILE_E, J * D)
    if (g.dtype != torch.float32 or g.shape != shape or not g.is_contiguous()
            or g.get_device() != ins.get_device() or g.data_ptr() % 16):
        raise TypeError(f"gate_scatter_bwd: g must be a contiguous, 16-byte "
                        f"aligned float32 {shape} on {ins.device}, got "
                        f"{g.dtype} {tuple(g.shape)} on {g.device}")
    dev = ins.device
    W, nwin = kernel_window("gate_scatter_bwd", D, J, ins.dtype, dev, window)
    dvals = torch.empty((ndir, B, Fp, D), dtype=vals[0].dtype, device=dev)
    dprior = (torch.empty((ndir, B, Fp), dtype=torch.float32, device=dev)
              if need_dprior else None)
    # per-part partials of dins: each tile's chunk range runs in up to P
    # blocks
    P = _load().gate_scatter_parts()
    ws = (torch.empty((ndir, B, n_tiles, P, J * D), dtype=torch.float32,
                      device=dev) if need_dins else None)
    dins = torch.empty(ins.shape, dtype=ins.dtype, device=dev) if need_dins else None
    _launch("gate_scatter_bwd", dev,
            vals[0].data_ptr(), vals[-1].data_ptr(), ins.data_ptr(),
            prior[0].data_ptr(), prior[-1].data_ptr(), scatter[0].data_ptr(),
            scatter[-1].data_ptr(), chunk_starts[0].data_ptr(),
            chunk_starts[-1].data_ptr(), g.data_ptr(), dvals.data_ptr(),
            dprior.data_ptr() if need_dprior else None,
            ws.data_ptr() if need_dins else None,
            dins.data_ptr() if need_dins else None, ndir, B, Fp, D, J,
            n_tiles, int(bool(apply_relu)), int(ins.dtype == torch.bfloat16),
            W, ws_bytes=4 * nwin * ndir * B * Fp if nwin > 1 and need_dprior
            else 0)
    bwd_launches += 1
    bwd_launches_1dir += ndir == 1
    return (dvals.unbind(0), dprior.unbind(0) if need_dprior else None, dins)


class GateScatterFn(torch.autograd.Function):
    """``gate_scatter_fwd`` with ``gate_scatter_bwd`` as its gradient.

    ``apply(apply_relu, ins, *vals, *prior, *scatter, *chunk_starts)``, one
    tensor per direction in each group -> ``[ndir,B,E,J*D]``. Gradients flow
    to ``ins``, vals and prior; the int tensors get none. Work for an input
    that needs no gradient (TypeLayer's unit instructions and mask priors) is
    skipped."""

    @staticmethod
    def forward(ctx, apply_relu, ins, *tensors):
        n = len(tensors) // 4
        vals, prior, scatter, starts = (tensors[i * n:(i + 1) * n]
                                        for i in range(4))
        ctx.apply_relu = apply_relu
        ctx.save_for_backward(ins, *tensors)
        return gate_scatter_fwd(vals, ins, prior, scatter, starts, apply_relu)

    @staticmethod
    def backward(ctx, g):
        ins, *tensors = ctx.saved_tensors
        n = len(tensors) // 4
        vals, prior, scatter, starts = (tensors[i * n:(i + 1) * n]
                                        for i in range(4))
        need_dprior = any(ctx.needs_input_grad[2 + n:2 + 2 * n])
        dvals, dprior, dins = gate_scatter_bwd(
            vals, ins, prior, scatter, starts, g.contiguous(), ctx.apply_relu,
            need_dprior=need_dprior, need_dins=ctx.needs_input_grad[1])
        return (None, dins, *dvals,
                *(dprior if need_dprior else (None,) * n), *(None,) * (2 * n))


def gate_scatter_both(vals_f: torch.Tensor, vals_i: torch.Tensor,
                      ins: torch.Tensor, prior_f: torch.Tensor,
                      prior_i: torch.Tensor, layout, num_entities: int,
                      apply_relu: bool = True):
    """Both message directions in one launch (the v4 op): projected fact
    values ``[B, Fp, D]`` per direction -> ``(out_f, out_i)``, each
    ``[B, E, J*D]`` j-major; differentiable through ``GateScatterFn``."""
    _check_entities(layout.fwd, num_entities)
    out = GateScatterFn.apply(
        apply_relu, ins.contiguous(), vals_f.contiguous(), vals_i.contiguous(),
        prior_f.contiguous(), prior_i.contiguous(), layout.fwd.scatter,
        layout.inv.scatter, layout.fwd.chunk_starts, layout.inv.chunk_starts)
    # unbind: its backward stacks the two gradients into one contiguous
    # cotangent for the kernel
    return out.unbind(0)


def gate_scatter_projected(fact_rl: torch.Tensor, ins: torch.Tensor,
                           prior: torch.Tensor, direction, num_entities: int,
                           apply_relu: bool = True) -> torch.Tensor:
    """One direction (the v3 op): ``[B, Fp, D]`` projected fact values ->
    ``[B, J, E, D]``, differentiable through ``GateScatterFn``. NSM calls it
    at J = 1 on every step (the forward direction, its teacher the inverse).
    ReaRev does not: under ``GNN_RAG_GATE_SCATTER=v3`` it runs both
    directions through ``gate_scatter_both``, which computes the same
    function (on the TPU, v3 and v4 differ only in how the output block fits
    VMEM)."""
    _check_entities(direction, num_entities)
    out = GateScatterFn.apply(apply_relu, ins.contiguous(),
                              fact_rl.contiguous(), prior.contiguous(),
                              direction.scatter, direction.chunk_starts)[0]
    B, E, JD = out.shape
    J = ins.shape[1]
    return out.reshape(B, E, J, JD // J).movedim(2, 1)


def _check_entities(direction, num_entities: int):
    n_tiles = direction.chunk_starts.shape[-1] - 1
    if n_tiles * TILE_E != num_entities:
        raise ValueError(f"gate_scatter: layout has {n_tiles} tiles of "
                         f"{TILE_E}, num_entities={num_entities}")


# ------------------------------------------------- fused-projection op (K6a-c)
def fused_gate_scatter_fwd_plain(fact_rel, w, bias, ins: torch.Tensor, prior,
                                 scatter, chunk_starts,
                                 apply_relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the fused-projection kernel, same contract
    and numerics (see ``fused_gate_scatter_fwd``): ``rl`` in float32 with the
    bias added in float32, rounded once to the input type (pallas_mp.py:
    140-145), then the gate of ``gate_scatter_fwd_plain``."""
    rl = (fact_rel.float() @ w.float() + bias.float()).to(fact_rel.dtype)
    return gate_scatter_fwd_plain((rl,), ins, (prior,), (scatter,),
                                  (chunk_starts,), apply_relu)[0]


def _check_proj(fact_rel, w, bias, ins, prior, scatter, chunk_starts):
    _check((fact_rel,), ins, (prior,), (scatter,), (chunk_starts,))
    D = ins.shape[-1]
    for name, t, shape in (("w", w, (D, D)), ("bias", bias, (D,))):
        if (t.dtype != ins.dtype or t.shape != shape
                or t.get_device() != ins.get_device() or not t.is_contiguous()):
            raise TypeError(f"gate_scatter: {name} must be a contiguous "
                            f"{ins.dtype} {shape} on {ins.device}, got "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def fused_gate_scatter_fwd(fact_rel: torch.Tensor, w: torch.Tensor,
                           bias: torch.Tensor, ins: torch.Tensor,
                           prior: torch.Tensor, scatter: torch.Tensor,
                           chunk_starts: torch.Tensor,
                           apply_relu: bool = True, *,
                           window: int | None = None) -> torch.Tensor:
    """One direction of the fused-projection op: ``[B,Fp,D]`` relation
    features of the fact slots, ``rel_linear``'s ``w [D,D]`` and ``bias [D]``
    and ``ins [B,J,D]``, all float32 or all bfloat16; ``[B,Fp]`` float32
    prior, ``[B,Fp]`` int32 scatter, ``[B,E/128+1]`` int32 chunk_starts ->
    ``[B,E,J*D]`` float32 with ``rl = fact_rel @ w + bias`` as the values of
    ``gate_scatter_fwd``. A window of rl's columns takes the whole
    fact_rel rows and w's columns of the window.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream or raise."""
    global fused_launches
    if ins.device.type == "cpu":
        return fused_gate_scatter_fwd_plain(fact_rel, w, bias, ins, prior,
                                            scatter, chunk_starts, apply_relu)
    if ins.device.type != "cuda":
        raise ValueError(f"gate_scatter: unsupported device {ins.device}")
    _check_proj(fact_rel, w, bias, ins, prior, scatter, chunk_starts)
    B, Fp, D = fact_rel.shape
    J = ins.shape[1]
    n_tiles = chunk_starts.shape[-1] - 1
    W, _ = kernel_window("fused_gate_scatter_fwd", D, J, ins.dtype, ins.device,
                         window)
    out = torch.empty((B, n_tiles * TILE_E, J * D), dtype=torch.float32,
                      device=ins.device)
    # partial tiles of the tiles whose chunk range is split over blocks
    slots = _load().fused_gate_scatter_fwd_slots(Fp)
    ws = torch.empty((B, slots, TILE_E * J * D), dtype=torch.float32,
                     device=ins.device)
    _launch("fused_gate_scatter_fwd", ins.device, fact_rel.data_ptr(),
            w.data_ptr(), bias.data_ptr(), ins.data_ptr(), prior.data_ptr(),
            scatter.data_ptr(), chunk_starts.data_ptr(), out.data_ptr(),
            ws.data_ptr(), B, Fp, D, J, n_tiles, int(bool(apply_relu)),
            int(ins.dtype == torch.bfloat16), W)
    fused_launches += 1
    return out


def fused_gate_scatter_bwd_plain(fact_rel, w, bias, ins: torch.Tensor, prior,
                                 scatter, chunk_starts, g: torch.Tensor,
                                 apply_relu: bool = True):
    """Plain PyTorch version of the fused-projection backward kernel, same
    contract and numerics (see ``fused_gate_scatter_bwd``): the JAX op's XLA
    backward (pallas_mp.py:484-507) in float32 from the widened inputs, with
    ``rl`` and the prior unrounded as the TPU backward kernel has them
    (:345-352). ``w`` may be ``[D, W]``, rl's columns of one window (with
    ``bias``, ``ins`` and ``g`` of those columns): dfact_rel is then the
    window's part of the sum over rl's columns."""
    B, Fp, _ = fact_rel.shape
    J, W = ins.shape[1], w.shape[1]
    fr, wf, insf = fact_rel.float(), w.float(), ins.float()
    rl = fr @ wf + bias.float()                                   # [B,Fp,W]
    pre = rl[:, :, None, :] * insf[:, None, :, :]                 # [B,Fp,J,W]
    act = torch.relu(pre) if apply_relu else pre
    gb = torch.gather(g, 1, scatter.clamp_min(0).long()[..., None].expand(
        B, Fp, J * W))
    gb = torch.where((scatter >= 0)[..., None], gb, 0.0).reshape(B, Fp, J, W)
    dprior = (gb * act).sum(dim=(2, 3))
    dval = gb * prior[:, :, None, None]
    if apply_relu:
        dval = torch.where(pre > 0, dval, 0.0)
    drl = torch.einsum("bfjd,bjd->bfd", dval, insf)
    dins = torch.einsum("bfjd,bfd->bjd", dval, rl)
    dw = torch.einsum("bfd,bfe->de", fr, drl)
    return ((drl @ wf.T).to(fact_rel.dtype), dw.to(w.dtype),
            drl.sum(dim=(0, 1)).to(bias.dtype), dins.to(ins.dtype), dprior)


def fused_gate_scatter_bwd(fact_rel: torch.Tensor, w: torch.Tensor,
                           bias: torch.Tensor, ins: torch.Tensor,
                           prior: torch.Tensor, scatter: torch.Tensor,
                           chunk_starts: torch.Tensor, g: torch.Tensor,
                           apply_relu: bool = True, *,
                           window: int | None = None):
    """Backward of ``fused_gate_scatter_fwd`` for the same inputs and the
    ``[B,E,J*D]`` float32 cotangent ``g`` of its output -> ``(dfact_rel, dw,
    dbias, dins, dprior)`` in the types of the inputs (the JAX order,
    pallas_mp.py:444-445). ``dw`` and ``dbias`` are summed over every fact of
    the batch; pad slots get zero gradients. Columns run in windows as in
    the forward; over several windows, dfact_rel (``drl @ w^T``, a sum
    over every column) and dprior are float partials of each window, added
    in window order, dfact_rel rounded once.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream or raise."""
    global fused_bwd_launches
    if ins.device.type == "cpu":
        return fused_gate_scatter_bwd_plain(fact_rel, w, bias, ins, prior,
                                            scatter, chunk_starts, g,
                                            apply_relu)
    if ins.device.type != "cuda":
        raise ValueError(f"gate_scatter: unsupported device {ins.device}")
    _check_proj(fact_rel, w, bias, ins, prior, scatter, chunk_starts)
    B, Fp, D = fact_rel.shape
    J = ins.shape[1]
    n_tiles = chunk_starts.shape[-1] - 1
    shape = (B, n_tiles * TILE_E, J * D)
    if (g.dtype != torch.float32 or g.shape != shape or not g.is_contiguous()
            or g.get_device() != ins.get_device() or g.data_ptr() % 16):
        raise TypeError(f"fused_gate_scatter_bwd: g must be a contiguous, "
                        f"16-byte aligned float32 {shape} on {ins.device}, "
                        f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    dev = ins.device
    W, nwin = kernel_window("fused_gate_scatter_bwd", D, J, ins.dtype, dev,
                            window)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    dfr, dprior = empty(fact_rel.shape, fact_rel.dtype), empty((B, Fp))
    dins, dw, db = empty(ins.shape, ins.dtype), empty(w.shape, w.dtype), empty(
        bias.shape, bias.dtype)
    # per-part partials: each tile's chunk range runs in up to P blocks
    P = _load().gate_scatter_parts()
    dins_ws = empty((B, n_tiles, P, J * D))
    dw_ws = empty((B * n_tiles * P, D * D + D))
    _launch("fused_gate_scatter_bwd", dev, fact_rel.data_ptr(), w.data_ptr(),
            bias.data_ptr(), ins.data_ptr(), prior.data_ptr(),
            scatter.data_ptr(), chunk_starts.data_ptr(), g.data_ptr(),
            dfr.data_ptr(), dprior.data_ptr(), dins_ws.data_ptr(),
            dins.data_ptr(), dw_ws.data_ptr(), dw.data_ptr(), db.data_ptr(),
            B, Fp, D, J, n_tiles, int(bool(apply_relu)),
            int(ins.dtype == torch.bfloat16), W,
            ws_bytes=4 * nwin * B * Fp * (D + 1) if nwin > 1 else 0)
    fused_bwd_launches += 1
    return dfr, dw, db, dins, dprior


class FusedGateScatterFn(torch.autograd.Function):
    """``fused_gate_scatter_fwd`` with ``fused_gate_scatter_bwd`` as its
    gradient: ``apply(apply_relu, fact_rel, w, bias, ins, prior, scatter,
    chunk_starts)`` -> ``[B,E,J*D]``; gradients flow to fact_rel, w, bias,
    ins and prior."""

    @staticmethod
    def forward(ctx, apply_relu, *inputs):
        ctx.apply_relu = apply_relu
        ctx.save_for_backward(*inputs)
        return fused_gate_scatter_fwd(*inputs, apply_relu)

    @staticmethod
    def backward(ctx, g):
        grads = fused_gate_scatter_bwd(*ctx.saved_tensors, g.contiguous(),
                                       ctx.apply_relu)
        return None, *grads, None, None


def gate_scatter(fact_rel: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 ins: torch.Tensor, prior: torch.Tensor, direction,
                 num_entities: int, apply_relu: bool = True) -> torch.Tensor:
    """One direction of the fused-projection op (the JAX package's
    ``gate_scatter``, pallas_mp.py:810): ``[B, Fp, D]`` relation features of
    the fact slots and ``rel_linear``'s ``w``, ``bias`` -> ``[B, J, E, D]``,
    differentiable through ``FusedGateScatterFn``."""
    _check_entities(direction, num_entities)
    out = FusedGateScatterFn.apply(
        apply_relu, fact_rel.contiguous(), w.contiguous(), bias.contiguous(),
        ins.contiguous(), prior.contiguous(), direction.scatter,
        direction.chunk_starts)
    B, E, JD = out.shape
    J = ins.shape[1]
    return out.reshape(B, E, J, JD // J).movedim(2, 1)


# ------------------------------------------------------- scatter_mm (K6d)
def scatter_mm_fwd_plain(values: torch.Tensor, scatter_idx: torch.Tensor,
                     chunk_tiles: torch.Tensor,
                     num_entities: int) -> torch.Tensor:
    """Plain PyTorch version of the scatter kernel, same contract and
    numerics (see ``scatter_mm_fwd``): float32 sums of the values."""
    v = torch.where((scatter_idx >= 0)[..., None], values.float(), 0.0)
    return batched_segment_sum(v, scatter_idx.clamp_min(0), num_entities)


def scatter_mm_fwd(values: torch.Tensor, scatter_idx: torch.Tensor,
                   chunk_tiles: torch.Tensor, num_entities: int, *,
                   window: int | None = None) -> torch.Tensor:
    """``out[b, scatter_idx[b, f], :] += float(values[b, f, :])``: values
    ``[B, Fp, C]`` float32 or bfloat16 in the tile-sorted layout order,
    ``[B, Fp]`` int32 scatter_idx (-1 on pad slots), ``[B, Fp/128]`` int32
    chunk_tiles (non-decreasing per row, as the layout builds them) ->
    ``[B, E, C]`` float32. It runs the forward's kernel (J 1, D = C, no
    gate): a block holds a ``[128, W]`` float tile of a window of W columns
    and two or more stages of 32 rows in shared memory, so any C runs, in
    windows of up to 302 (float32) or 362 (bfloat16) columns.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream or raise."""
    global scatter_launches
    if values.device.type == "cpu":
        return scatter_mm_fwd_plain(values, scatter_idx, chunk_tiles, num_entities)
    if values.device.type != "cuda":
        raise ValueError(f"scatter_mm: unsupported device {values.device}")
    B, Fp, C = values.shape
    if (values.dtype not in (torch.float32, torch.bfloat16) or Fp % TILE_F
            or num_entities % TILE_E or not values.is_contiguous()
            or values.data_ptr() % 16):
        raise TypeError(f"scatter_mm: values must be a contiguous, 16-byte "
                        f"aligned float32 or bfloat16 [B, Fp, C] with Fp a "
                        f"multiple of {TILE_F} (E={num_entities} a multiple "
                        f"of {TILE_E}), got {values.dtype} "
                        f"{tuple(values.shape)}")
    dev = values.get_device()
    for name, t, shape in (("scatter_idx", scatter_idx, (B, Fp)),
                           ("chunk_tiles", chunk_tiles, (B, Fp // TILE_F))):
        if (t.dtype != torch.int32 or t.shape != shape or t.get_device() != dev
                or not t.is_contiguous()):
            raise TypeError(f"scatter_mm: {name} must be a contiguous int32 "
                            f"{shape} on {values.device}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
    W, _ = kernel_window("scatter_mm_fwd", C, 1, values.dtype, values.device,
                         window)
    out = torch.empty((B, num_entities, C), dtype=torch.float32,
                      device=values.device)
    _launch("scatter_mm_fwd", values.device, values.data_ptr(),
            scatter_idx.data_ptr(), chunk_tiles.data_ptr(), out.data_ptr(), B,
            Fp, C, num_entities // TILE_E, int(values.dtype == torch.bfloat16),
            W, ws_bytes=4 * B * _fwd_slots(Fp) * TILE_E * C)
    scatter_launches += 1
    return out


class ScatterMMFn(torch.autograd.Function):
    """``scatter_mm_fwd``; its gradient is the cotangent gathered at each
    slot's target, zero on pad slots, in the values' type (pallas_mp.py:
    103-108)."""

    @staticmethod
    def forward(ctx, values, scatter_idx, chunk_tiles, num_entities):
        ctx.save_for_backward(scatter_idx)
        ctx.dtype = values.dtype
        return scatter_mm_fwd(values, scatter_idx, chunk_tiles, num_entities)

    @staticmethod
    def backward(ctx, g):
        scatter_idx, = ctx.saved_tensors
        B, Fp = scatter_idx.shape
        dv = torch.gather(g, 1, scatter_idx.clamp_min(0).long()[..., None]
                          .expand(B, Fp, g.shape[-1]))
        dv = torch.where((scatter_idx >= 0)[..., None], dv, 0.0)
        return dv.to(ctx.dtype), None, None, None


def scatter_mm(values: torch.Tensor, scatter_idx: torch.Tensor,
               chunk_tiles: torch.Tensor, num_entities: int) -> torch.Tensor:
    """The JAX package's ``scatter_mm`` (pallas_mp.py:58): values ``[B, Fp,
    C]`` (layout order), scatter_idx ``[B, Fp]`` (-1 pad), chunk_tiles
    ``[B, NC]`` -> ``[B, E, C]`` float32, differentiable."""
    return ScatterMMFn.apply(values.contiguous(), scatter_idx, chunk_tiles,
                             num_entities)
