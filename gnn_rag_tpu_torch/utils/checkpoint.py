"""Checkpoints of the port: a model's ``state_dict`` in one file.

Port of ``gnn_rag_tpu.utils.checkpoint`` (reference equivalent: torch.save
and load of ``model_state_dict``, train_model.py:236-253) with plain
``torch.save`` / ``torch.load(weights_only=True)``. A partial load keeps the
reference's ``load_state_dict(strict=False)`` meaning as the JAX package's
``merge_pytrees`` has it: a tensor is taken from the checkpoint only where
its name and shape match the target; everything else keeps the target's
value.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch


def save_state(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write ``state_dict`` (as CPU tensors) to ``path``, atomically."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)


def validate_shapes(restored: Mapping[str, torch.Tensor],
                    target: Mapping[str, torch.Tensor], context: str = "") -> None:
    """Raise ``ValueError`` naming every tensor whose name is missing on one
    side or whose shape differs, instead of an opaque error at load time."""
    bad = [f"{k}: checkpoint {tuple(restored[k].shape)} vs model "
           f"{tuple(v.shape)}" for k, v in target.items()
           if k in restored and tuple(restored[k].shape) != tuple(v.shape)]
    bad += [f"{k}: not in the checkpoint" for k in target if k not in restored]
    bad += [f"{k}: not in the model" for k in restored if k not in target]
    if bad:
        raise ValueError(
            f"checkpoint layout mismatch{' (' + context + ')' if context else ''}: "
            + "; ".join(bad[:4]) + (f"; +{len(bad) - 4} more" if len(bad) > 4 else ""))


def merge_state(target: Mapping[str, torch.Tensor],
                source: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``target`` with each tensor replaced by the one of the same name in
    ``source`` where the shapes match."""
    return {k: source[k] if k in source and tuple(source[k].shape) == tuple(v.shape)
            else v for k, v in target.items()}


def load_state(path: str, target: Optional[Mapping[str, torch.Tensor]] = None,
               partial: bool = True) -> Dict[str, torch.Tensor]:
    """Read a checkpoint written by ``save_state``. With a ``target`` state
    dict, ``partial=True`` overlays the checkpoint on it (``merge_state``)
    and ``partial=False`` requires the same names and shapes."""
    raw = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if target is None:
        return raw
    if partial:
        return merge_state(target, raw)
    validate_shapes(raw, target, context=path)
    return raw
