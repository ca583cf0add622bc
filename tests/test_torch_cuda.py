"""The gate-scatter CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU (and nvcc for the first build) and skips
without one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the CPU suite.)
Tolerance: fp32 max|kernel - plain| <= 1e-5 * max|plain| + 1e-6 (sum order:
the kernel walks facts in layout order, the plain version adds with
atomics); bf16 inputs 2e-2 relative, both sides taking the same bf16 values
and summing in float32.
"""

import numpy as np
import pytest
import torch

from gnn_rag_tpu_torch.config import Config, DataConfig, ModelConfig
from gnn_rag_tpu_torch.data.batch import GraphBatch
from gnn_rag_tpu_torch.data.kernel_layout import (TILE_E, build_sample_direction,
                                                  pack_samples)
from gnn_rag_tpu_torch.models.rearev import build_model
from gnn_rag_tpu_torch.ops import gate_scatter as gs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def layout(B, E, F, rng, pad_rows=0):
    fwd, inv = [], []
    for _ in range(B):
        h = rng.integers(0, E, F).astype(np.int32)
        t = rng.integers(0, E, F).astype(np.int32)
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


def inputs(J, D, dtype, device, *, B=3, E=512, F=1500, pad_rows=1, seed=0):
    rng = np.random.default_rng(seed)
    kl = layout(B, E, F, rng, pad_rows)
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
    (2, 50, True, torch.bfloat16), (3, 50, False, torch.bfloat16)])
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
def test_kernel_wrappers_and_checks(cuda):
    vals, ins, prior, scatter, starts = inputs(2, 16, torch.float32, cuda)
    E = (starts.shape[-1] - 1) * TILE_E
    with pytest.raises(RuntimeError, match="requires grad"):
        gs.gate_scatter_fwd(vals.clone().requires_grad_(), ins, prior, scatter,
                            starts)
    with pytest.raises(TypeError):
        gs.gate_scatter_fwd(vals, ins, prior.double(), scatter, starts)
    # J*D beyond one block's shared memory: the launch's error is raised,
    # and cleared, so the next launch goes through
    with pytest.raises(RuntimeError, match="launch failed"):
        gs.gate_scatter_fwd(vals, ins.repeat(1, 20, 1), prior, scatter, starts)
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


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_rearev_forward_kernel_vs_plain(cuda, compute_dtype, monkeypatch):
    """The whole eval forward on the card through the kernel and through
    the plain version: same answer distribution."""
    rng = np.random.default_rng(1)
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
        entity_dim=50, num_iter=3, num_ins=2, num_gnn=3,
        compute_dtype=compute_dtype))
    model = build_model(cfg, 100, R - 1, word_dim=W, seed=0, device=cuda)
    rel = [torch.randn((R, 3, W), device=cuda) * 0.1 for _ in range(2)]
    rel.append(torch.ones((R, 3), device=cuda))
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
