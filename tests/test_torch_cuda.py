"""The CUDA kernels against their plain PyTorch versions, on the card: the
gate-scatter forward and backward, the fused-projection forward and
backward and scatter_mm (alone, at widths a block holds only in column
windows, and in a ReaRev training step under GNN_RAG_GATE_SCATTER=v2),
and the flash-attention forward, dq and dk/dv
kernels (alone, through autograd, and in a LlamaLM; at head dims 128,
256, .., 2304 in float32 and to 4096 in bf16 and float16), and the flash
kernels' clusters accepted by the card (float32: one to sixteen blocks,
D / 128, and twelve of 192-column shares at 2176 and 2304; bf16 and
float16 from 384: two to sixteen, ceil(D / 256)).

Every test here needs an NVIDIA GPU (and nvcc for the first build) and skips
without one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the CPU suite.)
Tolerance: fp32 max|kernel - plain| <= 1e-5 * max|plain| + 1e-6 (sum order:
the kernel walks facts in layout order, the plain version adds with
atomics); bf16 inputs 2e-2 relative, both sides taking the same bf16 values
and summing in float32. The fused-projection kernels in bf16 per element
(``bf16_tol``: the rl each side rounds from its own float sum may round
the other way). Flash attention: fp32 outputs and lse 1e-4 of
max|plain| (the online softmax rescales in another order than the two-pass
one); bf16 and float16 outputs per element (``assert_flash_close``: one
bf16 or float16 step plus the rounding of p, scaled by the row; float16
also one subnormal step, 2^-24); the plain backward takes the plain
forward's lse and delta (float16, and bf16 past head dim 512: the kernels'
own, lse held to the plain forward's; both past 512 forward and backward
evaluated in float64, the exact function); float16 also with the
cotangent x 2^-16 and x 2^4 (the kernels' scaled split of p and ds); at
L = 1 (one key) dq and dk
are exactly 0 and are held to the float noise of dp - delta. A LlamaLM in
bf16 or float16: flash vs plain within twice the plain path's own distance
from fp32, logits and every gradient.
"""

import math
import os

import numpy as np
import pytest

# cuBLAS repeats its sums bit for bit under torch.use_deterministic_algorithms
# only with this workspace setting, read before its first call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402

from gnn_rag_tpu_torch.config import Config, DataConfig, ModelConfig
from gnn_rag_tpu_torch.data.batch import GraphBatch
from gnn_rag_tpu_torch.data.kernel_layout import (TILE_E, build_sample_direction,
                                                  pack_samples)
from gnn_rag_tpu_torch.llm import flash_attention as fa
from gnn_rag_tpu_torch.llm.model import LlamaConfig, build_llama
from gnn_rag_tpu_torch.train.trainer import build_model
from gnn_rag_tpu_torch.ops import gate_scatter as gs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def layout(B, E, F, rng, pad_rows=0, skew=False):
    """Random subgraphs laid out by the loader's code; ``skew``: each fact's
    target drawn as E u^4, so a few tiles hold most chunks."""
    fwd, inv = [], []
    for _ in range(B):
        h = rng.integers(0, E, F).astype(np.int32)
        t = rng.integers(0, E, F).astype(np.int32)
        if skew:
            t = (E * rng.random(F) ** 4).astype(np.int32)
        r = rng.integers(0, 4, F).astype(np.int32)
        w = np.ones(F, np.float32)
        fwd.append(build_sample_direction(t, h, r, w, E, 4))
        inv.append(build_sample_direction(h, t, r, w, E, 4))
    e = np.zeros(0, np.int32)
    pad = build_sample_direction(e, e, e, np.zeros(0, np.float32), E, 4)
    fwd += [pad] * pad_rows
    inv += [pad] * pad_rows
    nc = max(len(s[4]) for s in fwd + inv)
    return pack_samples(fwd, inv, E, 4, num_chunks=-(-nc // 8) * 8)


def inputs(J, D, dtype, device, *, B=3, E=512, F=1500, pad_rows=1, seed=0,
           skew=False):
    rng = np.random.default_rng(seed)
    kl = layout(B, E, F, rng, pad_rows, skew)
    Bp, Fp = kl.fwd.scatter.shape
    g = torch.Generator(device=device).manual_seed(seed)
    scatter = torch.from_numpy(np.stack([kl.fwd.scatter, kl.inv.scatter])).to(device)
    starts = torch.from_numpy(np.stack([kl.fwd.chunk_starts,
                                        kl.inv.chunk_starts])).to(device)
    vals = torch.randn((2, Bp, Fp, D), generator=g, device=device).to(dtype)
    ins = torch.randn((Bp, J, D), generator=g, device=device).to(dtype)
    prior = torch.rand((2, Bp, Fp), generator=g, device=device) * (scatter >= 0)
    return vals, ins, prior, scatter, starts


@pytest.mark.cuda
@pytest.mark.parametrize("J,D,apply_relu,dtype", [
    (1, 50, False, torch.float32), (2, 50, True, torch.float32),
    (3, 50, True, torch.float32), (2, 16, True, torch.float32),
    (2, 50, True, torch.bfloat16), (3, 50, False, torch.bfloat16),
    # odd D: one column a thread (an even D takes two)
    (2, 15, True, torch.float32), (1, 15, False, torch.bfloat16)])
def test_kernel_matches_plain(cuda, J, D, apply_relu, dtype):
    args = inputs(J, D, dtype, cuda)
    before = gs.launches
    got = gs.gate_scatter_fwd(*args, apply_relu)
    torch.cuda.synchronize()
    assert gs.launches == before + 1
    want = gs.gate_scatter_fwd_plain(*args, apply_relu)
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item() + 1e-6, err
    assert not got[:, -1].any()          # batch-padding row: all pads
    # deterministic: no atomics, one fixed sum order
    assert torch.equal(got, gs.gate_scatter_fwd(*args, apply_relu))


@pytest.mark.cuda
@pytest.mark.parametrize("J,D,apply_relu,dtype", [
    (1, 50, False, torch.float32), (2, 50, True, torch.float32),
    (3, 50, True, torch.float32), (2, 16, True, torch.float32),
    (2, 50, True, torch.bfloat16), (3, 50, False, torch.bfloat16),
    # past the register path (J <= 3, D <= 64): ins and dins in shared memory
    (4, 16, True, torch.float32), (2, 80, True, torch.float32)])
def test_bwd_kernel_matches_plain(cuda, J, D, apply_relu, dtype):
    vals, ins, prior, scatter, starts = inputs(J, D, dtype, cuda)
    E = (starts.shape[-1] - 1) * TILE_E
    g = torch.randn((2, vals.shape[1], E, J * D),
                    generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda)
    args = (vals, ins, prior, scatter, starts, g, apply_relu)
    before = gs.bwd_launches
    got = gs.gate_scatter_bwd(*args)
    torch.cuda.synchronize()
    assert gs.bwd_launches == before + 1
    want = gs.gate_scatter_bwd_plain(*args)
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip([*got[0], *got[1], got[2]], [*want[0], *want[1], want[2]]):
        assert a.dtype == b.dtype
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rel * b.float().abs().max().item() + 1e-6, err
    pad = scatter < 0
    assert not got[0][0][pad[0]].any() and not got[1][1][pad[1]].any()
    # deterministic: no atomics, one fixed sum order
    again = gs.gate_scatter_bwd(*args)
    for a, b in zip([*got[0], *got[1], got[2]], [*again[0], *again[1], again[2]]):
        assert torch.equal(a, b)
    # the parts not needed are skipped, the rest is unchanged
    dv, dp, di = gs.gate_scatter_bwd(*args, need_dprior=False, need_dins=False)
    assert dp is None and di is None and torch.equal(dv[1], got[0][1])


@pytest.mark.cuda
def test_kernel_wrappers_and_checks(cuda):
    vals, ins, prior, scatter, starts = inputs(2, 16, torch.float32, cuda)
    E = (starts.shape[-1] - 1) * TILE_E
    with pytest.raises(TypeError):
        gs.gate_scatter_fwd(vals, ins, prior.double(), scatter, starts)
    g = torch.ones((2, vals.shape[1], E, 32), device=cuda)
    with pytest.raises(TypeError):
        gs.gate_scatter_bwd(vals, ins, prior, scatter, starts, g.double())
    # J*D beyond one block's shared memory runs in column windows; a window
    # forced wider than fits is refused by the launch, whose error is
    # raised and cleared, so the next launch goes through
    wide = (vals, ins.repeat(1, 20, 1), prior, scatter, starts)
    assert gs.kernel_window("gate_scatter_fwd", 16, 40, torch.float32)[1] > 1
    with pytest.raises(RuntimeError, match="launch failed"):
        gs.gate_scatter_fwd(*wide, window=16)
    with pytest.raises(RuntimeError, match="launch failed"):
        gs.gate_scatter_bwd(*wide, g.repeat(1, 1, 1, 20), window=16)
    with pytest.raises(ValueError, match="window"):
        gs.gate_scatter_fwd(*wide, window=0)
    check_gate_fwd(wide, True, 1e-5)
    both = gs.gate_scatter_fwd(vals, ins, prior, scatter, starts)
    torch.cuda.synchronize()
    # per-direction lists are the same call as tensors stacked on axis 0
    assert torch.equal(both, gs.gate_scatter_fwd(list(vals), ins, list(prior),
                                                 list(scatter), list(starts)))
    proj = gs.gate_scatter_projected(vals[1], ins, prior[1],
                                     _Dir(scatter[1], starts[1]), E)
    B = vals.shape[1]
    assert torch.equal(proj, both[1].reshape(B, E, 2, 16).movedim(2, 1))


class _Dir:
    def __init__(self, scatter, chunk_starts):
        self.scatter, self.chunk_starts = scatter, chunk_starts


# (J, D) of the windowed card checks: TypeLayer-like J 40 at D 16 (the
# shape the kernels refused before they took windows), CWQ's three
# instructions at entity dim 128, NSM and TypeLayer at 256, J 2 at 384
WIDE = [(40, 16), (3, 128), (1, 256), (2, 384)]
# the windows of K1 and K2 at WIDE on an H100 (227 KB of shared memory a
# block) in float32, from the kernels' layouts: K1 a [128, J*W] tile and two
# 32-slot stages, K2 145 J*W floats and two 64-slot stages
WIDE_WINDOWS = {("gate_scatter_fwd", 40, 16): (8, 2),
                ("gate_scatter_fwd", 3, 128): (128, 1),
                ("gate_scatter_fwd", 1, 256): (256, 1),
                ("gate_scatter_fwd", 2, 384): (128, 3),
                ("gate_scatter_bwd", 40, 16): (8, 2),
                ("gate_scatter_bwd", 3, 128): (64, 2),
                ("gate_scatter_bwd", 1, 256): (128, 2),
                ("gate_scatter_bwd", 2, 384): (128, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("J,D", WIDE)
def test_windowed_kernels_match_plain(cuda, J, D, dtype):
    """K1 and K2 at widths one block cannot hold whole: the column windows
    the kernels' fit entries give, against the plain versions (fp32 1e-5,
    bf16 2e-2 of max|plain|), bit for bit on a repeat; and against another
    window width (8 columns): the forward, dvals and dins bit for bit (each
    column's sums do not depend on the window), dprior (a sum over the
    windows' float partials) within 1e-5 of max|dprior|. On split tiles too
    (chunk_inputs' tiles of up to 40 chunks)."""
    f32 = dtype == torch.float32
    rel = 1e-5 if f32 else 2e-2
    if f32:
        for name in ("gate_scatter_fwd", "gate_scatter_bwd"):
            assert gs.kernel_window(name, D, J, dtype) == WIDE_WINDOWS[name, J, D]
    for make in (inputs, chunk_inputs):
        vals, ins, prior, scatter, starts = make(J, D, dtype, cuda)
        B, E = vals.shape[1], (starts.shape[-1] - 1) * TILE_E
        fargs = (vals, ins, prior, scatter, starts)
        out = check_gate_fwd(fargs, True, rel)
        assert torch.equal(out, gs.gate_scatter_fwd(*fargs, True, window=8))
        g = torch.randn((2, B, E, J * D), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(3))
        bargs = (*fargs, g, True)
        got = check_gate_bwd(bargs, rel)
        other = gs.gate_scatter_bwd(*bargs, window=8)
        assert all(torch.equal(a, b) for a, b in zip(got[0], other[0]))
        assert torch.equal(got[2], other[2])
        for a, b in zip(got[1], other[1]):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_fused_kernels_match_plain(cuda, dtype):
    """K6a/b and K6c (GNN_RAG_GATE_SCATTER=v2) at CWQ's three instructions
    and entity dim 128: two 64-column windows (w's [128, 128] and the
    [128, 384] tile do not fit a block beside the stages), against the
    plain versions as test_fused_kernels_match_plain holds them, bit for
    bit on a repeat; against 32-column windows: the forward, dw, db and dins
    bit for bit, dfact_rel and dprior (float partials of each window added
    in window order) within 1e-5 of their largest entry in float32, one
    bf16 step of dfact_rel in bf16."""
    f32 = dtype == torch.float32
    assert gs.kernel_window("fused_gate_scatter_fwd", 128, 3, dtype) == (64, 2)
    assert gs.kernel_window("fused_gate_scatter_bwd", 128, 3, dtype) == (64, 2)
    args = proj_inputs(3, 128, dtype, cuda)
    out = check_fused_fwd(args, True, f32)
    assert torch.equal(out, gs.fused_gate_scatter_fwd(*args, True, window=32))
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda)
                    .manual_seed(3), device=cuda)
    got = gs.fused_gate_scatter_bwd(*args, g, True)
    again = gs.fused_gate_scatter_bwd(*args, g, True)
    assert_parts_close(got, gs.fused_gate_scatter_bwd_plain(*args, g, True),
                       (1e-4 if f32 else (1,),) * 4 + (1e-4,))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    other = gs.fused_gate_scatter_bwd(*args, g, True, window=32)
    assert all(torch.equal(got[i], other[i]) for i in (1, 2, 3))
    assert_parts_close((got[0], got[4]), (other[0], other[4]),
                       (1e-5 if f32 else (1,), 1e-5))
    pad = args[5] < 0
    assert not got[0][pad].any() and not got[4][pad].any()


def proj_inputs(J, D, dtype, device, **kw):
    """One direction of ``inputs`` plus rel_linear's w [D,D] and b [D]."""
    vals, ins, prior, scatter, starts = inputs(J, D, dtype, device, **kw)
    g = torch.Generator(device=device).manual_seed(7)
    w = (torch.randn((D, D), generator=g, device=device) / D ** 0.5).to(dtype)
    b = (0.1 * torch.randn((D,), generator=g, device=device)).to(dtype)
    return vals[0], w, b, ins, prior[0], scatter[0], starts[0]


def assert_parts_close(got, want, rules):
    """Each output against its plain version: a rule is a share of
    max|want| (+ 1e-6), or ``(steps,)``: per element within ``bf16_tol``."""
    for i, (a, b, rule) in enumerate(zip(got, want, rules)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        d = (a.float() - b.float()).abs()
        if isinstance(rule, tuple):
            assert bool((d <= bf16_tol(b, *rule)).all()), (
                i, d.div(bf16_tol(b, *rule)).nan_to_num(nan=0.0).max().item())
        else:
            err = d.max().item()
            assert err <= rule * b.float().abs().max().item() + 1e-6, (i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("J,D,apply_relu,dtype", [
    (1, 50, True, torch.float32), (2, 50, True, torch.float32),
    (3, 50, False, torch.float32), (2, 16, True, torch.float32),
    (2, 50, True, torch.bfloat16), (3, 50, True, torch.bfloat16)])
def test_fused_kernels_match_plain(cuda, J, D, apply_relu, dtype):
    """The fused-projection forward and backward kernels against their plain
    versions, as chip_smoke.check_fused_kernels holds them: fp32 forward
    1e-5, backward 1e-4 of max|plain| (dW and db sum every fact of the
    batch in another order); bf16 per element, the forward within two bf16
    steps (rl rounded, then rl * ins), the bf16 gradients within one, dprior
    (float) 1e-4 of max|plain|. The backward's five outputs repeat bit for
    bit."""
    args = proj_inputs(J, D, dtype, cuda)
    before = (gs.fused_launches, gs.fused_bwd_launches)
    got = gs.fused_gate_scatter_fwd(*args, apply_relu)
    want = gs.fused_gate_scatter_fwd_plain(*args, apply_relu)
    f32 = dtype == torch.float32
    assert_parts_close((got,), (want,), (1e-5 if f32 else (2,),))
    assert not got[-1].any()             # batch-padding row: all pads
    assert torch.equal(got, gs.fused_gate_scatter_fwd(*args, apply_relu))
    g = torch.randn(got.shape, generator=torch.Generator(device=cuda)
                    .manual_seed(3), device=cuda)
    dgot = gs.fused_gate_scatter_bwd(*args, g, apply_relu)
    again = gs.fused_gate_scatter_bwd(*args, g, apply_relu)
    torch.cuda.synchronize()
    assert (gs.fused_launches, gs.fused_bwd_launches) == (before[0] + 2,
                                                          before[1] + 2)
    assert_parts_close(dgot, gs.fused_gate_scatter_bwd_plain(
        *args, g, apply_relu), (1e-4 if f32 else (1,),) * 4 + (1e-4,))
    assert all(torch.equal(a, b) for a, b in zip(dgot, again))
    pad = args[5] < 0
    assert not dgot[0][pad].any() and not dgot[4][pad].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,E,F,J,skew", [
    (16, 2048, 6553, 2, False),     # WebQSP bucket, one direction
    (8, 4096, 13107, 3, False),     # CWQ
    (16, 2048, 6553, 2, True)])     # skewed: a few tiles hold most chunks
def test_fused_bwd_kernel_at_model_shapes(cuda, B, E, F, J, skew, dtype):
    """The fused-projection backward (K6c) at the model's shapes, as
    test_fused_kernels_match_plain holds it (fp32 1e-4 of max|plain|, bf16
    gradients one bf16 step, dprior 1e-4): tiles split over several blocks
    whose partials are added in a fixed order, bit for bit on a repeat."""
    args = proj_inputs(J, 50, dtype, cuda, B=B, E=E, F=F, pad_rows=0,
                       skew=skew)
    starts = args[6]
    if skew:
        assert (starts[:, 1:] - starts[:, :-1]).max() >= 16
    g = torch.randn((B, E, J * 50), generator=torch.Generator(device=cuda)
                    .manual_seed(5), device=cuda)
    got = gs.fused_gate_scatter_bwd(*args, g, True)
    again = gs.fused_gate_scatter_bwd(*args, g, True)
    f32 = dtype == torch.float32
    assert_parts_close(got, gs.fused_gate_scatter_bwd_plain(*args, g, True),
                       (1e-4 if f32 else (1,),) * 4 + (1e-4,))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def chunk_inputs(J, D, dtype, device, counts=((0, 16, 40, 3, 8),
                                               (32, 1, 0, 4, 2)), seed=4):
    """Gate inputs on a layout whose tiles hold exactly ``counts[b][t]``
    chunks of facts in the forward direction (the inverse direction's
    targets are uniform), with 8 padding chunks past the last tile's range.
    A tile of 0 is empty: the loader gives it one chunk of pad slots."""
    rng = np.random.default_rng(seed)
    n_tiles = len(counts[0])
    E = n_tiles * TILE_E
    fwd, inv = [], []
    for row in counts:
        t = np.concatenate([rng.integers(i * TILE_E, (i + 1) * TILE_E,
                                         c * 128 - (rng.integers(0, 100) if c else 0))
                            for i, c in enumerate(row)]).astype(np.int32)
        h = rng.integers(0, E, len(t)).astype(np.int32)
        r = rng.integers(0, 4, len(t)).astype(np.int32)
        w = np.ones(len(t), np.float32)
        fwd.append(build_sample_direction(t, h, r, w, E, 4))
        inv.append(build_sample_direction(h, t, r, w, E, 4))
    nc = max(len(s[4]) for s in fwd + inv) + 8
    kl = pack_samples(fwd, inv, E, 4, num_chunks=-(-nc // 8) * 8)
    assert [list(np.diff(s)) for s in kl.fwd.chunk_starts] == [
        [max(1, c) for c in row] for row in counts]
    Bp, Fp = kl.fwd.scatter.shape
    g = torch.Generator(device=device).manual_seed(seed)
    scatter = torch.from_numpy(np.stack([kl.fwd.scatter, kl.inv.scatter])).to(device)
    starts = torch.from_numpy(np.stack([kl.fwd.chunk_starts,
                                        kl.inv.chunk_starts])).to(device)
    vals = torch.randn((2, Bp, Fp, D), generator=g, device=device).to(dtype)
    ins = torch.randn((Bp, J, D), generator=g, device=device).to(dtype)
    prior = torch.rand((2, Bp, Fp), generator=g, device=device) * (scatter >= 0)
    return vals, ins, prior, scatter, starts


def flat(x):
    """The tensors of a kernel's result (nested tuples, None skipped)."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x if item is not None for t in flat(item)]


def check_gate_bwd(args, rel):
    """K2 against its plain version (``rel`` of max|plain| + 1e-6), bit for
    bit on a repeat; the outputs not needed are skipped and the rest is
    unchanged."""
    before = gs.bwd_launches
    got = gs.gate_scatter_bwd(*args)
    again = gs.gate_scatter_bwd(*args)
    torch.cuda.synchronize()
    assert gs.bwd_launches == before + 2
    want = gs.gate_scatter_bwd_plain(*args)
    for a, b in zip(flat(got), flat(want)):
        assert a.dtype == b.dtype
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rel * b.float().abs().max().item() + 1e-6, err
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
    dv, dp, di = gs.gate_scatter_bwd(*args, need_dprior=False, need_dins=False)
    assert dp is None and di is None
    assert all(torch.equal(a, b) for a, b in zip(dv, got[0]))
    _, dp, di = gs.gate_scatter_bwd(*args, need_dprior=False)
    assert dp is None and torch.equal(di, got[2])
    _, dp, di = gs.gate_scatter_bwd(*args, need_dins=False)
    assert di is None and all(torch.equal(a, b) for a, b in zip(dp, got[1]))
    return got


def check_gate_fwd(args, apply_relu, rel):
    """K1 against its plain version (``rel`` of max|plain| + 1e-6), bit for
    bit on a repeat; rows the plain version leaves zero (empty tiles,
    entities no fact targets) are zero."""
    before = gs.launches
    got = gs.gate_scatter_fwd(*args, apply_relu)
    again = gs.gate_scatter_fwd(*args, apply_relu)
    torch.cuda.synchronize()
    assert gs.launches == before + 2
    want = gs.gate_scatter_fwd_plain(*args, apply_relu)
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item() + 1e-6, err
    assert torch.equal(got, again)
    assert not got[~want.any(-1)].any()
    return got


def chunk_tiles(starts, nc):
    """A layout's chunk_tiles [B, nc] from its chunk_starts [B, n_tiles+1]:
    chunk c's tile is the number of tile ranges that end at or before c,
    the padding chunks past the last range repeating the last tile."""
    B, n_tiles = starts.shape[0], starts.shape[1] - 1
    tiles = torch.searchsorted(starts[:, 1:].contiguous(),
                               torch.arange(nc, device=starts.device,
                                            dtype=torch.int32)
                               .expand(B, nc).contiguous(), right=True)
    return tiles.clamp_max(n_tiles - 1).to(torch.int32)


def check_scatter(scatter, starts, C, dtype, seed):
    """K6d at width C on one direction's layout against its plain version
    (1e-5 of max|plain|: float sums of the same values), bit for bit on a
    repeat, rows the plain version leaves zero zero."""
    B, Fp = scatter.shape
    E = (starts.shape[-1] - 1) * TILE_E
    tiles = chunk_tiles(starts, Fp // 128)
    vals = torch.randn((B, Fp, C), device=scatter.device, generator=torch
                       .Generator(device=scatter.device).manual_seed(seed)).to(dtype)
    before = gs.scatter_launches
    got = gs.scatter_mm_fwd(vals, scatter, tiles, E)
    again = gs.scatter_mm_fwd(vals, scatter, tiles, E)
    torch.cuda.synchronize()
    assert gs.scatter_launches == before + 2
    want = gs.scatter_mm_fwd_plain(vals, scatter, tiles, E)
    assert_parts_close((got,), (want,), (1e-5,))
    assert torch.equal(got, again)
    assert not got[~want.any(-1)].any()


def check_fused_fwd(args, apply_relu, f32):
    """K6a/b against its plain version (fp32 1e-5 of max|plain|, bf16 two
    bf16 steps per element), bit for bit on a repeat."""
    before = gs.fused_launches
    got = gs.fused_gate_scatter_fwd(*args, apply_relu)
    again = gs.fused_gate_scatter_fwd(*args, apply_relu)
    torch.cuda.synchronize()
    assert gs.fused_launches == before + 2
    assert_parts_close((got,), (gs.fused_gate_scatter_fwd_plain(*args, apply_relu),),
                       (1e-5 if f32 else (2,),))
    assert torch.equal(got, again)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("J,apply_relu,dtype", [
    (2, True, torch.float32), (1, False, torch.float32),
    (3, True, torch.float32), (2, True, torch.bfloat16)])
def test_split_tiles_match_plain(cuda, J, apply_relu, dtype):
    """K1 (both directions, and one), K6a/b (one direction), K2 (both
    directions, and one) and K6d (at C = J*50) on tiles whose chunk counts
    sit on and around the part boundaries: an empty tile (one chunk of pad
    slots); 1-4 chunks (one part of K1, K6a/b and K6d); 8 (two parts of 4
    for K1, K6a/b and K6d, four of 2 for K2); 16 (K2's largest split, 8
    parts) and 32 (the forwards'); 40, more than any largest split covers;
    padding chunks past the last tile's range (in K6d's chunk_tiles, part
    of the last tile's range). dprior and dins not needed, and bf16."""
    vals, ins, prior, scatter, starts = chunk_inputs(J, 50, dtype, cuda)
    B, E = vals.shape[1], (starts.shape[-1] - 1) * TILE_E
    f32 = dtype == torch.float32
    for ndir in (2, 1):
        out = check_gate_fwd((vals[:ndir], ins, prior[:ndir], scatter[:ndir],
                              starts[:ndir]), apply_relu,
                             1e-5 if f32 else 2e-2)
        assert not out[0, 0, :TILE_E].any()
        assert not out[0, 1, 2 * TILE_E:3 * TILE_E].any()
    check_scatter(scatter[0], starts[0], J * 50, dtype, seed=9)
    g = torch.randn((2, B, E, J * 50), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(6))
    for ndir in (2, 1):
        got = check_gate_bwd((vals[:ndir], ins, prior[:ndir], scatter[:ndir],
                              starts[:ndir], g[:ndir], apply_relu),
                             1e-5 if f32 else 2e-2)
        pad = scatter[0] < 0               # pad slots and the padding chunks
        assert not got[0][0][pad].any() and not got[1][0][pad].any()
    w = (torch.randn((50, 50), device=cuda) / 50 ** 0.5).to(dtype)
    bias = (0.1 * torch.randn((50,), device=cuda)).to(dtype)
    out = check_fused_fwd((vals[0], w, bias, ins, prior[0], scatter[0],
                           starts[0]), apply_relu, f32)
    assert not out[0, :TILE_E].any() and not out[1, 2 * TILE_E:3 * TILE_E].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,E,F,J,skew", [
    (16, 2048, 6553, 2, False),     # WebQSP bucket
    (8, 4096, 13107, 3, False),     # CWQ
    (16, 2048, 6553, 2, True)])     # skewed: a few tiles hold most chunks
def test_gate_kernels_at_model_shapes(cuda, B, E, F, J, skew, dtype):
    """K1 and K2 (both directions), K6a/b (one direction) and K6d (C =
    J*50) at the model's shapes against their plain versions, as the tests
    above hold them: long tiles split over several blocks whose partials
    are added in a fixed order, bit for bit on a repeat."""
    vals, ins, prior, scatter, starts = inputs(J, 50, dtype, cuda, B=B, E=E,
                                               F=F, pad_rows=0, skew=skew)
    if skew:
        assert (starts[0, :, 1:] - starts[0, :, :-1]).max() >= 16
    f32 = dtype == torch.float32
    check_gate_fwd((vals, ins, prior, scatter, starts), True,
                   1e-5 if f32 else 2e-2)
    check_scatter(scatter[0], starts[0], J * 50, dtype, seed=10)
    g = torch.randn((2, B, E, J * 50), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(8))
    check_gate_bwd((vals, ins, prior, scatter, starts, g, True),
                   1e-5 if f32 else 2e-2)
    w = (torch.randn((50, 50), device=cuda) / 50 ** 0.5).to(dtype)
    bias = (0.1 * torch.randn((50,), device=cuda)).to(dtype)
    check_fused_fwd((vals[0], w, bias, ins, prior[0], scatter[0], starts[0]),
                    True, f32)


@pytest.mark.cuda
@pytest.mark.parametrize("C,dtype", [(100, torch.float32), (150, torch.float32),
                                     (100, torch.bfloat16), (8, torch.float32),
                                     (151, torch.float32), (302, torch.float32),
                                     (362, torch.bfloat16)])
def test_scatter_kernel_matches_plain(cuda, C, dtype):
    vals, _, _, scatter, starts = inputs(1, C, dtype, cuda)
    n_tiles = starts.shape[-1] - 1
    tiles = chunk_tiles(starts[0], scatter.shape[-1] // 128)
    before = gs.scatter_launches
    got = gs.scatter_mm_fwd(vals[0], scatter[0], tiles, n_tiles * TILE_E)
    torch.cuda.synchronize()
    assert gs.scatter_launches == before + 1
    want = gs.scatter_mm_fwd_plain(vals[0], scatter[0], tiles, n_tiles * TILE_E)
    assert_parts_close((got,), (want,), (1e-5,))
    x = vals[0].detach().clone().requires_grad_()
    gs.scatter_mm(x, scatter[0], tiles, n_tiles * TILE_E).sum().backward()
    assert torch.equal(x.grad, (scatter[0] >= 0)[..., None].expand_as(x).to(dtype))
    with pytest.raises(TypeError):
        gs.scatter_mm_fwd(vals[0], scatter[0].long(), tiles, n_tiles * TILE_E)


@pytest.mark.cuda
@pytest.mark.parametrize("C,dtype", [(303, torch.float32), (363, torch.bfloat16),
                                     (512, torch.float32), (512, torch.bfloat16)])
def test_scatter_kernel_refuses_wider_than_fits(cuda, C, dtype):
    """Past the widest window scatter_mm takes (302 float32, 362 bfloat16:
    the [128, W] tile and two 32-row stages fill a block's shared memory):
    C runs in windows, against the plain version (1e-5 of max|plain|) and
    bit for bit against 128-column windows; a window forced to all C
    columns is refused with the CUDA error, and cleared."""
    vals, _, _, scatter, starts = inputs(1, C, dtype, cuda)
    E = (starts.shape[-1] - 1) * TILE_E
    tiles = chunk_tiles(starts[0], scatter.shape[-1] // 128)
    assert gs.kernel_window("scatter_mm_fwd", C, 1, dtype)[1] == 2
    with pytest.raises(RuntimeError, match="launch failed"):
        gs.scatter_mm_fwd(vals[0], scatter[0], tiles, E, window=C)
    check_scatter(scatter[0], starts[0], C, dtype, seed=11)
    got = gs.scatter_mm_fwd(vals[0], scatter[0], tiles, E)
    assert torch.equal(got, gs.scatter_mm_fwd(vals[0], scatter[0], tiles, E,
                                              window=128))
    assert_parts_close((got,), (gs.scatter_mm_fwd_plain(vals[0], scatter[0],
                                                        tiles, E),), (1e-5,))


def model_batch(cuda, compute_dtype, seed=1):
    """A random B4 E512 layout batch and a WebQSP-width ReaRev on the card."""
    rng = np.random.default_rng(seed)
    B, E, F, R, W = 4, 512, 1500, 5, 32
    kl = layout(B, E, F, rng)
    Fc = 2048
    heads = np.zeros((B, Fc), np.int32)
    gids = np.full((B, E), 100, np.int32)
    gids[:, : E - 40] = rng.integers(0, 100, (B, E - 40))
    seed = np.zeros((B, E), np.float32)
    seed[:, 0] = 1.0
    batch = GraphBatch(
        heads=heads, rels=heads, tails=heads, fact_mask=heads.astype(np.float32),
        entity_gids=gids, ent_present=np.ones((B, E), np.float32),
        seed_dist=seed, query_entities=seed,
        answer_dist=(rng.random((B, E)) > 0.99).astype(np.float32),
        q_tokens=np.ones((B, 6), np.int32), q_mask=np.ones((B, 6), np.float32),
        q_hidden=rng.standard_normal((B, 6, W)).astype(np.float32),
        layout=kl).to(cuda)
    cfg = Config(data=DataConfig(), model=ModelConfig(
        entity_dim=50, num_iter=3, num_ins=2, num_gnn=3, linear_dropout=0.0,
        compute_dtype=compute_dtype))
    model = build_model(cfg, 100, R - 1, word_dim=W, seed=0, device=cuda)
    rel = [torch.randn((R, 3, W), device=cuda) * 0.1 for _ in range(2)]
    rel.append(torch.ones((R, 3), device=cuda))
    return model, batch, rel


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_rearev_forward_kernel_vs_plain(cuda, compute_dtype, monkeypatch):
    """The whole eval forward on the card through the kernel and through
    the plain version: same answer distribution."""
    model, batch, rel = model_batch(cuda, compute_dtype)
    before = gs.launches
    with torch.inference_mode():
        _, _, got = model(batch, *rel)
        assert gs.launches == before + 10
        monkeypatch.setattr(gs, "gate_scatter_fwd", gs.gate_scatter_fwd_plain)
        _, _, want = model(batch, *rel)
    # fp32: only the sum order differs; bf16: an f32 sum-order difference can
    # flip one bf16 rounding of the next step's instructions
    rtol = 1e-4 if compute_dtype == "float32" else 2e-2
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= rtol * want.abs().max().item()


@pytest.mark.cuda
def test_rearev_train_step_grads_kernel_vs_plain(cuda, monkeypatch):
    """One training forward + backward on the card through both kernels and
    through both plain versions: every parameter gradient agrees to 1e-4 of
    its largest entry + 1e-7 (fp32; only sum orders differ). The two biases
    that feed only a softmax have a gradient of 0 up to rounding (the
    softmax is shift invariant): both paths must give |g| <= 1e-5."""
    model, batch, rel = model_batch(cuda, "float32")

    def grads():
        model.zero_grad(set_to_none=True)
        model(batch, *rel, training=True)[0].backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    fwd0, bwd0 = gs.launches, gs.bwd_launches
    got = grads()
    torch.cuda.synchronize()
    assert gs.launches == fwd0 + 10 and gs.bwd_launches == bwd0 + 10
    monkeypatch.setattr(gs, "gate_scatter_fwd", gs.gate_scatter_fwd_plain)
    monkeypatch.setattr(gs, "gate_scatter_bwd", gs.gate_scatter_bwd_plain)
    want = grads()
    for name, w in want.items():
        if name in ("reasoning.score_func.bias",
                    "instruction_decoder.ca_linear.bias"):
            assert max(got[name].abs().max(), w.abs().max()) <= 1e-5, name
            continue
        err = (got[name] - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-7, (name, err)


@pytest.mark.cuda
def test_rearev_v2_train_step_grads_kernel_vs_plain(cuda, monkeypatch):
    """GNN_RAG_GATE_SCATTER=v2: one training forward + backward launches the
    fused kernels 2 x num_iter x num_gnn = 18 times each (TypeLayer still one
    gate-scatter launch); every gradient, rel_linear's included, agrees
    with the plain versions as in the v4 test above, and the answer
    distribution with v4's. The plain gradients, the yardstick, are taken
    under torch.use_deterministic_algorithms: the plain versions' float
    atomics (index_add_) change their last bits from run to run (by up to
    ~3e-11 on an H100; the kernels' own path repeats bit for bit there)."""
    monkeypatch.setenv("GNN_RAG_GATE_SCATTER", "v2")
    model, batch, rel = model_batch(cuda, "float32")

    def grads():
        model.zero_grad(set_to_none=True)
        model(batch, *rel, training=True)[0].backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    before = (gs.fused_launches, gs.fused_bwd_launches, gs.launches)
    got = grads()
    torch.cuda.synchronize()
    assert (gs.fused_launches, gs.fused_bwd_launches, gs.launches) == (
        before[0] + 18, before[1] + 18, before[2] + 1)
    with torch.inference_mode():
        dist = model(batch, *rel)[2]
        monkeypatch.setenv("GNN_RAG_GATE_SCATTER", "v4")
        assert_rel(dist, model(batch, *rel)[2], 1e-4, "pred_dist v2 vs v4")
    monkeypatch.setenv("GNN_RAG_GATE_SCATTER", "v2")
    for name in ("fused_gate_scatter_fwd", "fused_gate_scatter_bwd",
                 "gate_scatter_fwd", "gate_scatter_bwd"):
        monkeypatch.setattr(gs, name, getattr(gs, name + "_plain"))
    torch.use_deterministic_algorithms(True)
    try:
        want = grads()
    finally:
        torch.use_deterministic_algorithms(False)
    for name, w in want.items():
        if name in ("reasoning.score_func.bias",
                    "instruction_decoder.ca_linear.bias"):
            assert max(got[name].abs().max(), w.abs().max()) <= 1e-5, name
            continue
        err = (got[name] - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-7, (name, err)


def assert_rel(got, want, rel, name):
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    assert got.dtype == want.dtype and err <= rel * ref, (name, err, ref)


def assert_flash_close(got, want, name):
    """A flash output against its plain version: float32 outputs (lse in
    every type) to 1e-4 of max|want|; bf16 outputs per element to
    2^-7 |want| + 1e-2 rms over the row's D values + 1e-3 rms(want): one
    bf16 step, the rounding of p at another point of the online softmax,
    float noise of rows whose exact value is 0; float16 outputs to
    ``f16_tol``, the same form at float16's step (chip_smoke.attn_err)."""
    if got.dtype == torch.float32:
        return assert_rel(got, want, 1e-4, name)
    d = (got.float() - want.float()).abs()
    tol = f16_tol(want) if want.dtype == torch.float16 else bf16_tol(want)
    assert want.dtype == got.dtype and bool((d <= tol).all()), (
        name, (d / tol).max().item())


def bf16_tol(b, steps=1):
    """Per-element tolerance of a result rounded to bf16 ``steps`` times on
    the way from float values the other side forms in another order:
    ``steps`` bf16 steps (2^-7 |b| each) + 1e-2 rms over the last axis +
    1e-3 rms(b) (chip_smoke.bf16_tol)."""
    sq = b.float().square()
    return (steps * 2 ** -7 * sq.sqrt() + 1e-2 * sq.mean(-1, keepdim=True).sqrt()
            + 1e-3 * sq.mean().sqrt())


def f16_tol(b):
    """Per-element tolerance of a float16 result: ``bf16_tol``'s form at
    float16's step, 2^-10 |b| + 1.25e-3 rms over the last axis +
    1.25e-4 rms(b), plus one subnormal step, 2^-24 (chip_smoke.f16_tol)."""
    sq = b.float().square()
    return (2 ** -10 * sq.sqrt() + 1.25e-3 * sq.mean(-1, keepdim=True).sqrt()
            + 1.25e-4 * sq.mean().sqrt() + 2 ** -24)


def check_flash_bwd(q, k, v, do, lse, delta, plse, pdelta, D):
    """dq, dk and dv of the kernels (from their forward's lse and delta)
    against the plain backward (from the plain forward's); at L = 1 (one
    key) dq and dk are exactly 0 and hold only the float noise of dp -
    delta (two float sums of D products, each within (D - 1) 2^-24 of
    sum |dO v|) times scale times k or q (float16: rounded, so within
    2^-11 of it plus a subnormal step). bf16 and float16 past head dim 512:
    the plain backward in float64, rounded (chip_smoke.exact_yardstick: the
    float32 sums' own noise at the first query row, whose exact dq and dk
    are 0, reaches the tolerance there). Returns the kernels' (dq, dk, dv)."""
    dq = fa.flash_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta)
    wide = q.dtype != torch.float32 and D > 512
    args = [x.double() if wide else x for x in (q, k, v, do, plse, pdelta)]
    pdq = fa.flash_dq_plain(*args).to(q.dtype)
    pdk, pdv = (x.to(q.dtype) for x in fa.flash_dkv_plain(*args))
    if q.shape[1] == 1:
        noise = (2 ** -15 / math.sqrt(D)) * (do.float() * v.float()).abs(
            ).sum(-1, keepdim=True)
        slack = (1 + 2 ** -10, 2 ** -24) if q.dtype == torch.float16 else (1, 0)
        for name, a, x in (("dq", dq, k), ("dk", dk, q)):
            bound = noise * x.float().abs() * slack[0] + slack[1]
            assert bool((a.float().abs() <= bound).all()), name
    else:
        assert_flash_close(dq, pdq, "dq")
        assert_flash_close(dk, pdk, "dk")
    assert_flash_close(dv, pdv, "dv")
    return dq, dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,dtype", [
    (2, 256, 4, torch.float32), (2, 256, 4, torch.bfloat16),
    (1, 1000, 2, torch.float32), (3, 77, 2, torch.bfloat16),
    (1, 64, 1, torch.float32),
    # TMA's bounds in the bf16 kernels: one row, under one tile, one row
    # past a 128-row tile, and the model's head stride (32 heads)
    (1, 1, 2, torch.bfloat16), (1, 63, 2, torch.bfloat16),
    (1, 129, 2, torch.bfloat16), (2, 300, 32, torch.bfloat16),
    # the SFT step's lengths: dq's 64-key tiles and 128-row blocks, ragged
    (1, 1000, 2, torch.bfloat16), (1, 2047, 2, torch.bfloat16),
    # the float32 kernels' edges: one row, one row past a 128-row block
    # (32-row Q tiles, 64-key tiles in dk/dv), the model's head stride
    (1, 1, 2, torch.float32), (1, 129, 2, torch.float32),
    (2, 300, 32, torch.float32),
    # float32 dq's 64-row blocks and 32-key tiles: one row past a block and
    # a tile, the SFT length, whole tiles half a block past one
    (1, 65, 2, torch.float32), (1, 2047, 2, torch.float32),
    (1, 96, 2, torch.float32),
    # float16 (the bf16 kernels' tiles): one row, one row past a 128-row
    # tile, the model's head stride, ragged lengths, the SFT length
    (2, 256, 4, torch.float16), (1, 1, 2, torch.float16),
    (1, 129, 2, torch.float16), (2, 300, 32, torch.float16),
    (1, 1000, 2, torch.float16), (1, 2047, 2, torch.float16)])
def test_flash_kernels_match_plain(cuda, B, L, H, dtype):
    flash_vs_plain(cuda, B, L, H, 128, dtype)


# cotangent scales of the float16 backward's extra runs: far under float16's
# normal range (ds below 2^-24 unless scaled), and large
F16_G_SCALES = (2.0 ** -16, 2.0 ** 4)


def flash_vs_plain(cuda, B, L, H, D, dtype):
    """The flash kernels at [B, L, H, D] in ``dtype`` against their plain
    versions, the backward twice bit for bit; float16 also with the
    cotangent x F16_G_SCALES."""
    g = torch.Generator(device=cuda).manual_seed(L)
    q, k, v, do = (torch.randn((B, L, H, D), generator=g, device=cuda
                               ).to(dtype) for _ in range(4))
    before = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    o, lse = fa.flash_fwd(q, k, v)
    po, plse = fa.flash_fwd_plain(q, k, v)
    exact = dtype != torch.float32 and D > 512   # chip_smoke.exact_yardstick
    if exact:
        po, plse = fa.flash_fwd_plain(q.double(), k.double(), v.double())
        po, plse = po.to(dtype), plse.float()
    assert_flash_close(o, po, "o")
    assert_flash_close(lse, plse, "lse")
    # the plain backward from the plain forward's lse: a wrong lse shows
    # here; float16, and bf16 past head dim 512, from the kernels' own lse
    # and delta (chip_smoke's check_attn_kernels: float16's p rounding flips
    # carry o's last bit through delta into rows of few keys, and past 512
    # delta sums that many products of o's difference), lse held above
    delta, pdelta = fa.bwd_delta(o, do), fa.bwd_delta(po, do)
    own = dtype == torch.float16 or exact
    dq, dk, dv = check_flash_bwd(q, k, v, do, lse, delta,
                                 lse if own else plse,
                                 delta if own else pdelta, D)
    # no float atomics: a second launch repeats bit for bit
    assert torch.equal(dq, fa.flash_dq(q, k, v, do, lse, delta))
    assert all(torch.equal(a, b) for a, b in
               zip((dk, dv), fa.flash_dkv(q, k, v, do, lse, delta)))
    extra = 0
    if dtype == torch.float16:
        for scale in F16_G_SCALES:
            ds = (do.float() * scale).half()
            delta_s = fa.bwd_delta(o, ds)
            got = check_flash_bwd(q, k, v, ds, lse, delta_s, lse, delta_s, D)
            if scale < 1 and L > 1:     # subnormal gradients, not zeros
                assert all(x.float().abs().max() > 0 for x in got)
            extra += 1
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        n + c for n, c in zip(before, (1, 2 + extra, 2 + extra)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("B,L,H", [
    # head dim 256: one row, under one tile, one row past a 128-row block
    # (and past dq's 32-key and dk/dv's 64-key tiles), one row past float32
    # dq's 64-row block, ragged lengths, Gemma-2B's 8 heads at the SFT
    # length (float32: a cluster of two blocks on each block of rows)
    (1, 1, 2), (1, 63, 2), (1, 65, 2), (1, 129, 2), (3, 77, 2), (2, 300, 8),
    (1, 1000, 2), (2, 2047, 8)])
def test_flash_d256_kernels_match_plain(cuda, B, L, H, dtype):
    flash_vs_plain(cuda, B, L, H, 256, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("D", [384, 512])
@pytest.mark.parametrize("B,L,H", [
    # head dims 384 and 512 (16-bit: a cluster of two blocks, each on half
    # of the columns; float32: of three or four, each on 128 columns, the
    # partial scores added in rank order): one row, under one tile, one row
    # past dq's 32-key and the forward's and dk/dv's 64-key tiles, one row
    # past a 128-row block (float32 dq: past a 64-row block), ragged
    # lengths, DeepSeek-V4-Flash's head shape at the SFT length (8 heads
    # repeated from one kv head)
    (1, 1, 2), (1, 33, 2), (1, 65, 2), (1, 129, 2), (3, 77, 2), (2, 300, 8),
    (1, 1000, 2), (2, 2047, 8)])
def test_flash_d512_kernels_match_plain(cuda, B, L, H, D, dtype):
    flash_vs_plain(cuda, B, L, H, D, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [640, 768, 896, 1024])
@pytest.mark.parametrize("B,L,H", [
    # float32 at head dims 640-1024 (clusters of five to eight blocks, each
    # on 128 columns, the partial scores added rank by rank): one row, one
    # row past dq's 64-row block and the forward's and dk/dv's 64-key
    # tiles, one past a 128-row block, a ragged length, and chip_smoke's
    # [kernel-attn] ragged rows at 4 heads
    (1, 1, 2), (1, 65, 4), (1, 129, 4), (3, 77, 2), (2, 1000, 4)])
def test_flash_d1024_fp32_kernels_match_plain(cuda, B, L, H, D):
    flash_vs_plain(cuda, B, L, H, D, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [640, 768, 896, 1024])
@pytest.mark.parametrize("B,L,H", [
    # bf16 and float16 at head dims 640-1024 (clusters of three, three, four
    # and four blocks of 192 or 256 columns, the partial scores added in
    # rank order): one row, chip_smoke's [kernel-attn] ragged rows at 4
    # heads (one row past the forward's and dk/dv's 64-key tiles, one past
    # a 128-row block, a ragged length), and the SFT length at 4 heads
    (1, 1, 2), (1, 65, 4), (1, 129, 4), (2, 1000, 4), (2, 2047, 4)])
def test_flash_d1024_16bit_kernels_match_plain(cuda, B, L, H, D, dtype):
    flash_vs_plain(cuda, B, L, H, D, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [1152, 1280, 1408, 1536, 1664, 1792, 1920,
                               2048])
@pytest.mark.parametrize("B,L,H", [
    # bf16 and float16 at head dims 1152-2048 (clusters of five to eight
    # blocks of 192 or 256 columns): one row, one row past the forward's
    # and dk/dv's 64-key tiles, one past a 128-row block, chip_smoke's
    # [kernel-attn] ragged row at 2 heads, the SFT length at 2 heads
    (1, 1, 2), (1, 65, 2), (1, 129, 2), (2, 1000, 2), (1, 2047, 2)])
def test_flash_d2048_16bit_kernels_match_plain(cuda, B, L, H, D, dtype):
    flash_vs_plain(cuda, B, L, H, D, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1152, 1280, 1408, 1536, 1664, 1792, 1920,
                               2048])
@pytest.mark.parametrize("B,L,H", [
    # float32 at head dims 1152-2048 (the instance <0> in clusters of nine
    # to sixteen blocks, each on 128 columns: Hopper's non-portable cluster
    # sizes): one row, one row past dq's 64-row block and the forward's and
    # dk/dv's 64-key tiles, one past a 128-row block, a ragged length,
    # chip_smoke's [kernel-attn] ragged row at 2 heads, the SFT length
    (1, 1, 2), (1, 65, 2), (1, 129, 2), (3, 77, 2), (2, 1000, 2),
    (1, 2047, 2)])
def test_flash_d2048_fp32_kernels_match_plain(cuda, B, L, H, D):
    flash_vs_plain(cuda, B, L, H, D, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2176, 2304])
@pytest.mark.parametrize("B,L,H", [
    # float32 at head dims 2176 and 2304 (twelve blocks of 192-column
    # shares, ten of 192 and two of 128 at 2176): one row, one row past the
    # forward's 32-key and the backward's 16-row tiles, one past a 64-row
    # block, chip_smoke's [kernel-attn] ragged row, the SFT length at one
    # head
    (1, 1, 1), (1, 17, 2), (1, 65, 2), (3, 77, 2), (2, 1000, 1),
    (1, 2047, 1)])
def test_flash_d2304_fp32_kernels_match_plain(cuda, B, L, H, D):
    flash_vs_plain(cuda, B, L, H, D, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [2176, 2304, 2432, 2688, 2944, 3200, 3456,
                               3712, 3968, 4096])
@pytest.mark.parametrize("B,L,H", [
    # bf16 and float16 at head dims 2176-4096 (clusters of nine to sixteen
    # blocks of 192 or 256 columns: the first head dim of each cluster size,
    # with two 192-column shares, and 2304 and 4096, all 256): one row, one
    # row past the forward's and dk/dv's 64-key tiles, one past a 128-row
    # block, chip_smoke's [kernel-attn] ragged row, the SFT length at one
    # head
    (1, 1, 2), (1, 65, 2), (1, 129, 2), (2, 1000, 2), (1, 2047, 1)])
def test_flash_d4096_16bit_kernels_match_plain(cuda, B, L, H, D, dtype):
    flash_vs_plain(cuda, B, L, H, D, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("D,dtype", [
    *((d, torch.float32) for d in range(128, 2305, 128)),
    *((d, t) for t in (torch.bfloat16, torch.float16)
      for d in range(384, 4097, 128))])
def test_flash_fp32_clusters_fit_the_card(cuda, kind, D, dtype):
    """The card holds at least one cluster of each float32 kernel at every
    head dim it takes (128 to 2048: D / 128 blocks of 198-230 KB of shared
    memory, one an SM: cudaOccupancyMaxActiveClusters; one block at 128;
    2176 and 2304: twelve blocks of 192-column shares, ``split3_shares``)
    and of each bf16 and float16 cluster kernel (384 to 4096: ceil(D / 256)
    blocks, two to sixteen, of up to 230 KB; past eight Hopper's
    non-portable cluster sizes), and at most one a block of SMs of the
    cluster's size; one head dim past each type's last raises."""
    n = fa.max_active_clusters(kind, D, dtype)
    blocks = (len(fa.cluster16_shares(D)) if dtype != torch.float32
              else len(fa.split3_shares(D)) if D > 2048 else D // 128)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 0 < n <= sms // blocks, n
    with pytest.raises(RuntimeError, match="cluster occupancy"):
        fa.max_active_clusters(kind, fa.HEAD_DIMS[dtype][-1] + 128, dtype)


@pytest.mark.cuda
def test_flash_autograd_and_checks(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, 130, 2, 128), generator=g, device=cuda
                           ).requires_grad_() for _ in range(3))
    do = torch.randn((2, 130, 2, 128), generator=g, device=cuda)
    fa.flash_attention(q, k, v).backward(do)
    got = (q.grad, k.grad, v.grad)
    o, lse = fa.flash_fwd_plain(q.detach(), k.detach(), v.detach())
    want = (fa.flash_dq_plain(q, k, v, do, lse, fa.bwd_delta(o, do)),
            *fa.flash_dkv_plain(q, k, v, do, lse, fa.bwd_delta(o, do)))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert_rel(a, b.detach(), 1e-4, name)
    with pytest.raises(ValueError, match="head dim 128"):
        fa.flash_fwd(*(torch.zeros(1, 8, 1, 64, device=cuda),) * 3)
    with pytest.raises(ValueError, match="a multiple of 128"):
        fa.flash_fwd(*(torch.zeros(1, 8, 1, 4224, device=cuda,
                                   dtype=torch.bfloat16),) * 3)
    with pytest.raises(ValueError, match="a multiple of 128"):
        fa.flash_fwd(*(torch.zeros(1, 8, 1, 2432, device=cuda),) * 3)
    x = torch.zeros(1, 8, 1, 128, device=cuda)
    with pytest.raises(ValueError, match="k must be"):
        fa.flash_fwd(x, x.half(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_llama_flash_vs_plain_attention(cuda, dtype):
    """A LlamaLM at head dim 128 on the card: the flash path launches one
    forward per layer and agrees with the plain attention path, logits and
    the loss gradient of every parameter. fp32: 1e-4 of the largest entry.
    bf16 and float16: the two paths round at different points, so each
    output's flash-vs-plain distance is held to twice the plain path's own
    distance from the same model in fp32."""
    cfg = LlamaConfig(vocab_size=300, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, intermediate=384, dtype=dtype)
    model = build_llama(cfg, seed=0, device=cuda)
    tokens = torch.randint(3, 300, (2, 200), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))

    def run(cfg, **changes):
        m = build_llama(LlamaConfig(**{**cfg.__dict__, **changes}), seed=0,
                        device=cuda)
        m.load_state_dict(model.state_dict())
        logits, _ = m(tokens)
        logits.logsumexp(-1).mean().backward()
        return [logits.detach()] + [p.grad for p in m.parameters()]

    n = fa.fwd_launches
    got = run(cfg)
    assert fa.fwd_launches == n + cfg.n_layers
    want = run(cfg, use_flash=False)
    names = ["logits"] + [name for name, _ in model.named_parameters()]
    if dtype == "float32":
        assert_rel(got[0], want[0], 1e-4, "logits")
        for name, a, b in zip(names[1:], got[1:], want[1:]):
            err = (a - b).abs().max().item()
            assert err <= 1e-4 * b.abs().max().item() + 1e-7, name
        return
    fp32 = run(cfg, dtype="float32", use_flash=False)
    for name, a, b, r in zip(names, got, want, fp32):
        own = (b.float() - r).norm().item()
        assert (a.float() - b.float()).norm().item() <= 2 * own, (name, own)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_llama_d256_flash_vs_plain_attention(cuda, dtype):
    """A bf16 or float16 LlamaLM at head dim 256 (Gemma-2B's heads: 8 of
    256, one kv head, tied embeddings; 2 layers) on the card: the flash path
    launches one forward, one dq and one dk/dv per layer, and each output
    (logits and every parameter's loss gradient) is within twice the plain
    path's own distance from the same model in float32 (as
    test_llama_flash_vs_plain_attention holds head dim 128)."""
    cfg = LlamaConfig(vocab_size=300, dim=2048, n_layers=2, n_heads=8,
                      n_kv_heads=1, intermediate=512, tie_embeddings=True,
                      dtype=dtype)
    model = build_llama(cfg, seed=0, device=cuda)
    tokens = torch.randint(3, 300, (2, 300), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))

    def run(**changes):
        m = build_llama(LlamaConfig(**{**cfg.__dict__, **changes}), seed=0,
                        device=cuda)
        m.load_state_dict(model.state_dict())
        logits, _ = m(tokens)
        logits.logsumexp(-1).mean().backward()
        return [logits.detach()] + [p.grad for p in m.parameters()]

    n = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    got = run()
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        c + cfg.n_layers for c in n)
    want = run(use_flash=False)
    # the yardstick stays off the float32 kernels under test elsewhere
    fp32 = run(dtype="float32", use_flash=False)
    names = ["logits"] + [name for name, _ in model.named_parameters()]
    for name, a, b, r in zip(names, got, want, fp32):
        own = (b.float() - r).norm().item()
        assert (a.float() - b.float()).norm().item() <= 2 * own, (name, own)


@pytest.mark.cuda
def test_llama_d256_fp32_flash_vs_plain_attention(cuda):
    """A float32 LlamaLM at head dim 256 (Gemma-2B's heads: 8 of 256, one kv
    head, tied embeddings; 2 layers) on the card: the flash path launches
    one forward, one dq and one dk/dv per layer (the float32 kernels at
    256), and its logits and every parameter's loss gradient are within
    1e-4 of the largest entry (+ 1e-7) of the plain attention path's."""
    cfg = LlamaConfig(vocab_size=300, dim=2048, n_layers=2, n_heads=8,
                      n_kv_heads=1, intermediate=512, tie_embeddings=True,
                      dtype="float32")
    model = build_llama(cfg, seed=0, device=cuda)
    tokens = torch.randint(3, 300, (2, 300), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))

    def run(**changes):
        m = build_llama(LlamaConfig(**{**cfg.__dict__, **changes}), seed=0,
                        device=cuda)
        m.load_state_dict(model.state_dict())
        logits, _ = m(tokens)
        logits.logsumexp(-1).mean().backward()
        return [logits.detach()] + [p.grad for p in m.parameters()]

    n = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    got = run()
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        c + cfg.n_layers for c in n)
    want = run(use_flash=False)
    names = ["logits"] + [name for name, _ in model.named_parameters()]
    for name, a, b in zip(names, got, want):
        err = (a - b).abs().max().item()
        assert torch.isfinite(a).all() and err <= (
            1e-4 * b.abs().max().item() + 1e-7), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("head_dim,n_heads", [
    pytest.param(384, 8, id="384"), pytest.param(512, 8, id="512"),
    pytest.param(640, 4, id="640"), pytest.param(1024, 4, id="1024"),
    pytest.param(1408, 2, id="1408"), pytest.param(2048, 2, id="2048"),
    pytest.param(4096, 1, id="4096")])
def test_llama_d512_flash_vs_plain_attention(cuda, head_dim, n_heads, dtype):
    """A bf16 or float16 LlamaLM at head dim 512 (DeepSeek-V4-Flash's head
    shape: heads of 512, one kv head; dim 4096, 8 heads) and at 384 (dim
    3072, 8 heads, one kv head), with 4 heads of 1024 (LLaMA-2-7B's 4,096
    query columns regrouped, the step-time-llm-d1024 model) and of 640,
    with 2 heads of 2048 (the step-time-llm-d2048 model) and of 1408, and
    with one head of 4096 (the step-time-llm-d4096 model), one kv head, 2
    layers, on the card: the flash path launches one forward, one dq and
    one dk/dv per layer (clusters of two, three, four, six, eight and
    sixteen blocks), and each output (logits and every parameter's loss
    gradient) is within twice the plain path's own distance from the same
    model in float32 (as test_llama_flash_vs_plain_attention holds head
    dim 128)."""
    cfg = LlamaConfig(vocab_size=300, dim=n_heads * head_dim, n_layers=2,
                      n_heads=n_heads, n_kv_heads=1, intermediate=512,
                      dtype=dtype)
    model = build_llama(cfg, seed=0, device=cuda)
    tokens = torch.randint(3, 300, (2, 300), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))

    def run(**changes):
        m = build_llama(LlamaConfig(**{**cfg.__dict__, **changes}), seed=0,
                        device=cuda)
        m.load_state_dict(model.state_dict())
        logits, _ = m(tokens)
        logits.logsumexp(-1).mean().backward()
        return [logits.detach()] + [p.grad for p in m.parameters()]

    n = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    got = run()
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        c + cfg.n_layers for c in n)
    want = run(use_flash=False)
    fp32 = run(dtype="float32", use_flash=False)
    names = ["logits"] + [name for name, _ in model.named_parameters()]
    for name, a, b, r in zip(names, got, want, fp32):
        own = (b.float() - r).norm().item()
        assert (a.float() - b.float()).norm().item() <= 2 * own, (name, own)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,n_heads", [
    pytest.param(384, 8, id="384"), pytest.param(512, 8, id="512"),
    pytest.param(640, 4, id="640"), pytest.param(1024, 4, id="1024"),
    pytest.param(1152, 2, id="1152"), pytest.param(2048, 2, id="2048")])
def test_llama_d512_fp32_flash_vs_plain_attention(cuda, head_dim, n_heads):
    """A float32 LlamaLM at head dim 512 (DeepSeek-V4-Flash's head shape:
    heads of 512, one kv head; dim 4096, 8 heads) and at 384 (dim 3072),
    with 4 heads of 1024 (LLaMA-2-7B's 4,096 query columns regrouped, the
    step-time-llm-d1024-fp32 model) and of 640, and with 2 heads of 2048
    (the step-time-llm-d2048-fp32 model) and of 1152, 2 layers, on the
    card: the flash path launches one forward, one dq and one dk/dv per
    layer (the float32 kernels in clusters of three, four, five, eight,
    nine and sixteen blocks), and its logits and every parameter's loss
    gradient are within 1e-4 of the largest entry (+ 1e-7) of the plain
    attention path's (as test_llama_d256_fp32_flash_vs_plain_attention
    holds head dim 256)."""
    cfg = LlamaConfig(vocab_size=300, dim=n_heads * head_dim, n_layers=2,
                      n_heads=n_heads, n_kv_heads=1, intermediate=512,
                      dtype="float32")
    model = build_llama(cfg, seed=0, device=cuda)
    tokens = torch.randint(3, 300, (2, 300), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))

    def run(**changes):
        m = build_llama(LlamaConfig(**{**cfg.__dict__, **changes}), seed=0,
                        device=cuda)
        m.load_state_dict(model.state_dict())
        logits, _ = m(tokens)
        logits.logsumexp(-1).mean().backward()
        return [logits.detach()] + [p.grad for p in m.parameters()]

    n = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    got = run()
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        c + cfg.n_layers for c in n)
    want = run(use_flash=False)
    names = ["logits"] + [name for name, _ in model.named_parameters()]
    for name, a, b in zip(names, got, want):
        err = (a - b).abs().max().item()
        assert torch.isfinite(a).all() and err <= (
            1e-4 * b.abs().max().item() + 1e-7), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,dtype", [(4224, "float16"),
                                            (4224, "bfloat16"),
                                            (2432, "float32")])
def test_llama_shapes_the_kernels_refuse_run_reference_attention(
        cuda, head_dim, dtype):
    """A LlamaLM whose attention the flash kernels do not take (head dim
    4224 in 16 bits: past a cluster of sixteen blocks of 256 columns,
    Hopper's largest; 2432 in float32: past twelve of 192, the JAX
    kernels' own float32 ceiling, about 2,304) runs on the card with no
    flash launch, through
    reference_attention: its logits equal the same model's with
    use_flash=False."""
    cfg = LlamaConfig(vocab_size=300, dim=2 * head_dim, n_layers=2, n_heads=2,
                      n_kv_heads=1, intermediate=384, dtype=dtype)
    model = build_llama(cfg, seed=0, device=cuda)
    tokens = torch.randint(3, 300, (2, 150), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    n = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    with torch.no_grad():
        logits, _ = model(tokens)
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == n
    plain = build_llama(LlamaConfig(**{**cfg.__dict__, "use_flash": False}),
                        seed=0, device=cuda)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        want, _ = plain(tokens)
    assert torch.isfinite(logits).all() and torch.equal(logits, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_llama_int8_on_card_matches_cpu(cuda, dtype, tol):
    """An int8 LlamaLM (``quantize_state_dict`` of a seeded model) on the
    card against the same model on the CPU: logits within ``tol`` of the
    largest (the GEMMs sum in other orders), the int8 weights moved
    unchanged."""
    from gnn_rag_tpu_torch.llm.model import LlamaLM
    from gnn_rag_tpu_torch.llm.quant import quantize_state_dict
    cfg = LlamaConfig(vocab_size=300, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, intermediate=384, dtype=dtype, quant="int8")
    full = build_llama(LlamaConfig(**{**cfg.__dict__, "quant": "none"}), seed=0,
                       device="cpu")
    state = quantize_state_dict(full.state_dict())
    tokens = torch.randint(3, 300, (2, 130),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        with torch.device(dev):
            m = LlamaLM(cfg)
        m.load_state_dict(state)
        assert m.layer_0.mlp.up_proj.weight_q.dtype == torch.int8
        with torch.no_grad():
            out[str(dev)] = m(tokens.to(dev))[0].cpu()
    want = out["cpu"]
    assert (out[str(cuda)] - want).abs().max().item() <= tol * want.abs().max().item()


def lora_setup(cuda, cfg, seed=0):
    """A seeded LlamaLM on the card and adapters on q/v with B drawn too
    (at init B = 0 and A's gradient is exactly 0)."""
    from gnn_rag_tpu_torch.llm.lora import init_lora
    model = build_llama(cfg, seed=seed, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    lora = init_lora(model, gen)
    for ab in lora.values():
        ab["b"].normal_(0.0, 0.02, generator=gen)
    return model, lora


def lora_batch(cuda, vocab, B, L):
    gen = torch.Generator(device=cuda).manual_seed(5)
    tokens = torch.randint(3, vocab, (B, L), device=cuda, generator=gen)
    mask = (torch.rand((B, L), device=cuda, generator=gen) < 0.6).float()
    return tokens, mask


@pytest.mark.cuda
def test_remat_adapter_grads_match_no_remat_with_flash(cuda):
    """LoRA adapters of a bf16 LlamaLM through the flash kernels: with
    remat each block's forward runs twice (K5a 2 x n_layers launches) and
    the loss and adapter gradients equal the no-remat ones bit for bit (the
    kernels use no atomics)."""
    from gnn_rag_tpu_torch.llm.lora import LoRATrainer
    cfg = LlamaConfig(vocab_size=300, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, intermediate=384, dtype="bfloat16")
    tokens, mask = lora_batch(cuda, 300, 2, 300)
    got = {}
    for remat in (False, True):
        model, lora = lora_setup(cuda, LlamaConfig(**{**cfg.__dict__,
                                                      "remat": remat}))
        tr = LoRATrainer(model, lora, lr=1e-3)
        n = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
        loss = tr.loss(tokens, mask)
        loss.backward()
        torch.cuda.synchronize()
        launches = tuple(a - b for a, b in zip(
            (fa.fwd_launches, fa.dq_launches, fa.dkv_launches), n))
        assert launches == ((1 + remat) * 2, 2, 2), (remat, launches)
        got[remat] = [loss.detach()] + [p.grad for p in tr.params]
    for a, b in zip(got[True], got[False]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_lora_step_kernels_vs_plain_full_width(cuda):
    """One LoRA step (remat, float32) at LLaMA2-7B width cut to 2 layers:
    loss and every adapter gradient through the flash kernels within 1e-4
    of the largest entry (+ 1e-7) of the plain attention path's."""
    from gnn_rag_tpu_torch.llm.lora import LoRATrainer
    cfg = LlamaConfig(n_layers=2, dtype="float32", remat=True)
    tokens, mask = lora_batch(cuda, cfg.vocab_size, 2, 257)

    def step(use_flash):
        model, lora = lora_setup(cuda, LlamaConfig(**{**cfg.__dict__,
                                                      "use_flash": use_flash}))
        tr = LoRATrainer(model, lora, lr=1e-3)
        loss = tr.train_step(tokens, mask)
        return [loss] + [p.grad for p in tr.params]

    n = fa.fwd_launches
    got = step(True)
    assert fa.fwd_launches == n + 2 * cfg.n_layers
    want = step(False)
    assert abs(got[0].item() - want[0].item()) <= 1e-5 * abs(want[0].item())
    for a, b in zip(got[1:], want[1:]):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item() + 1e-7


@pytest.mark.cuda
def test_speculative_equals_greedy_on_card(cuda):
    """Float32 on the card: the speculative tokens are the target's greedy
    tokens, with an independent draft and with the target as its own."""
    from gnn_rag_tpu_torch.llm.generate import Decoder, SpeculativeDecoder
    cfg = LlamaConfig(vocab_size=300, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, intermediate=384, dtype="float32")
    target = build_llama(cfg, seed=0, device=cuda).eval()
    draft = build_llama(LlamaConfig(**{**cfg.__dict__, "n_layers": 1}), seed=1,
                        device=cuda).eval()
    prompt = list(range(3, 40))
    want = Decoder(target, max_len=128).greedy(prompt, 32)
    for d, gamma in ((draft, 3), (target, 4)):
        spec = SpeculativeDecoder(target, d, max_len=128, gamma=gamma)
        assert spec.greedy(prompt, 32) == want
    assert spec.last_stats["draft_accepted"] >= 32 - 32 // 5 - 1
