"""SFT of the LLM reader: completion-only cross-entropy on one CUDA device.

Port of gnn_rag_tpu/llm_tpu/sft.py (the reference's trl SFTTrainer +
DataCollatorForCompletionOnlyLM, llm/src/joint_training/joint_finetuning.py
:84-185):

* the loss counts only the tokens after the LAST response template
  ("[/INST]"): ``sum(nll * mask) / max(sum(mask), 1)`` over float32
  ``log_softmax`` of the next-token logits;
* optax's ``clip_by_global_norm`` -> ``adamw`` (eps 1e-8, decoupled weight
  decay) with ``warmup_cosine_decay_schedule`` from 0, so step 0 runs at
  lr 0 and warmup is ``min(warmup_steps, max(total_steps // 10, 1))``;
* epoch-shuffled batches without replacement (``_batch_indices``), and
  ``checkpoint-<step>.pt`` files (the parameters, as the JAX trainer saves
  them) with auto-resume from the latest.

Every cache-free forward of the model runs the flash kernels on the card
(K5a), and its backward the dq and dk/dv kernels (K5b, K5c). ``report_to``
other than "none" is a no-op, as in the JAX trainer without wandb.

With a ``mesh`` (or ``dp * tp > 1``, which builds one from the ``torchrun``
environment: ``parallel.mesh.make_mesh``) each rank runs its dp rows of the
global batch through its tp part of the model (``llm.sharding``). The loss
stays that of the global batch: each dp rank divides its rows' NLL sum by
the global mask count (all-reduced), so the gradients are summed over dp,
not averaged; the clip's norm sums the tp slices. A tp that does not divide
the head counts keeps the attention, or its k and v projections, whole
(``llm.sharding``). Checkpoints are written whole, by rank 0. Without a
mesh the trainer runs the same steps on a mesh of one rank
(``parallel.collectives.local_mesh``).

    python -m gnn_rag_tpu_torch.llm.sft --data train_qa.jsonl [--n_layers 4
        --batch_size 8 --max_seq_len 2048 --total_steps 3000 ...] \
        [--device {cuda,cpu}]

is the counterpart of scripts/train_sft.sh: it tokenizes with the
byte-level tokenizer and initialises from ``--seed`` (importing LLaMA-2
weights waits for a checkpoint on the machine).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..cli import bool_flag
from ..parallel import collectives as coll
from ..utils.checkpoint import load_state, save_state
from .model import LlamaConfig, LlamaLM, build_llama
from .sharding import (full_llm_state, local_llm_state,
                       partial_grad_names, shard_llm_)

SEP, BOP, EOP, PAD = "<SEP>", "<PATH>", "</PATH>", "<PAD>"
RESPONSE_TEMPLATE = "[/INST]"


def resize_embeddings(state: dict, old_vocab: int, new_vocab: int) -> dict:
    """Mean-init rows for added tokens in a ``LlamaLM`` state_dict (new
    embedding and ``lm_head`` rows = the mean of the existing ones)."""
    if new_vocab == old_vocab:
        return state
    for name in ("tok_emb.weight", "lm_head.weight"):
        w = state[name]
        extra = w.mean(dim=0, keepdim=True).expand(new_vocab - old_vocab, -1)
        state[name] = torch.cat([w, extra])
    return state


def completion_mask(token_ids: Sequence[int],
                    template_ids: Sequence[int]) -> np.ndarray:
    """1.0 for label positions strictly after the LAST occurrence of the
    response template (DataCollatorForCompletionOnlyLM behaviour)."""
    ids = list(token_ids)
    t = list(template_ids)
    mask = np.zeros(len(ids), np.float32)
    last = -1
    for i in range(len(ids) - len(t) + 1):
        if ids[i:i + len(t)] == t:
            last = i
    if last >= 0:
        mask[last + len(t):] = 1.0
    return mask


def pack_examples(texts: List[str], tokenize: Callable[[str], List[int]],
                  template_ids: Sequence[int], max_len: int, pad_id: int):
    """texts -> (tokens [N, max_len] int32, loss_mask [N, max_len] float32)."""
    toks = np.full((len(texts), max_len), pad_id, np.int32)
    mask = np.zeros((len(texts), max_len), np.float32)
    for i, text in enumerate(texts):
        ids = tokenize(text)[:max_len]
        toks[i, :len(ids)] = ids
        mask[i, :len(ids)] = completion_mask(ids, template_ids)[:len(ids)]
    return toks, mask


def _nll_sum(logits, targets, mask):
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    return (nll * mask).sum()


def completion_loss(model: LlamaLM, tokens, loss_mask, count=None):
    """Completion-only NLL of next-token prediction (tokens [B, L]), over
    the mask's sum, or over ``count`` (a data-parallel rank's share: the
    global batch's mask sum)."""
    logits, _ = model(tokens[:, :-1])
    mask = loss_mask[:, 1:]
    count = mask.sum() if count is None else count
    return _nll_sum(logits, tokens[:, 1:], mask) / count.clamp_min(1.0)


def chunked_completion_loss(model: LlamaLM, tokens, loss_mask,
                            chunk: int = 2048, count=None):
    """``completion_loss`` with the vocab projection applied ``chunk``
    positions at a time under activation checkpointing, so only one
    [B, chunk, V] block of float32 logits is alive (forward or backward)."""
    hidden, _ = model(tokens[:, :-1], return_hidden=True)
    w = model.tok_emb.weight if model.cfg.tie_embeddings else model.lm_head.weight
    targets, mask = tokens[:, 1:], loss_mask[:, 1:]

    def chunk_nll(h, t, m):
        if model.vocab_tp is not None:
            return _nll_sum(model.head_logits(h), t, m)
        return _nll_sum(h.float() @ w.float().T, t, m)

    total = sum(checkpoint(chunk_nll, hidden[:, i:i + chunk],
                           targets[:, i:i + chunk], mask[:, i:i + chunk],
                           use_reentrant=False)
                for i in range(0, hidden.shape[1], chunk))
    count = mask.sum() if count is None else count
    return total / count.clamp_min(1.0)


def warmup_cosine_lr(step: int, peak: float, warmup: int, decay_steps: int
                     ) -> float:
    """optax ``warmup_cosine_decay_schedule(0, peak, warmup, decay_steps)``
    at ``step``: linear from 0 over ``warmup`` steps, then a cosine to 0."""
    if step < warmup:
        return peak * min(step, warmup) / warmup
    count = min(step - warmup, decay_steps - warmup)
    return peak * 0.5 * (1.0 + math.cos(math.pi * count / (decay_steps - warmup)))


@dataclass
class SFTConfig:
    output_dir: str = "saved_models/sft"
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    warmup_steps: int = 10
    total_steps: int = 1000
    batch_size: int = 8
    max_seq_len: int = 2048
    grad_clip: float = 1.0
    save_every: int = 200
    seed: int = 0
    dp: int = 1
    tp: int = 1
    report_to: str = "none"     # only "none" here (no reporting backend)
    # >0: compute the loss with chunked_completion_loss over this many
    # tokens at a time; 0 = dense lm_head
    loss_chunk: int = 0


class SFTTrainer:
    def __init__(self, model_cfg: LlamaConfig, cfg: SFTConfig, params=None,
                 device="cuda", mesh=None):
        """``params``: a whole ``LlamaLM`` state_dict (e.g. ``bridge.
        llama_from_flax`` of the JAX trainer's params), else flax-family
        random weights from ``cfg.seed``; ``mesh``: a ``parallel.mesh.Mesh``
        (default: one from the ``torchrun`` environment when ``cfg.dp *
        cfg.tp > 1``), whose device the model takes."""
        if mesh is None:
            mesh = (coll.make_mesh(cfg.dp, cfg.tp, device=device)
                    if cfg.dp * cfg.tp > 1 else coll.local_mesh(device))
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device
        self.model = build_llama(model_cfg, seed=cfg.seed, device=self.device)
        if params is not None:
            self.model.load_state_dict(params)
        coll.replicate(mesh, self.model)
        shards = set(shard_llm_(self.model, mesh))
        partial = partial_grad_names(self.model)
        self.model.train()
        named = list(self.model.named_parameters())
        self.params = [p for _, p in named]
        self.sharded = [p for n, p in named if n in shards]
        # whole on each tp rank, each rank's gradient its part (summed)
        self.partial = [p for n, p in named if n in partial]
        self.replicated = [p for n, p in named
                           if n not in shards and n not in partial]
        self.warmup = min(cfg.warmup_steps, max(cfg.total_steps // 10, 1))
        self.decay_steps = max(cfg.total_steps, self.warmup + 1)
        self.opt = torch.optim.AdamW(self.params, lr=0.0, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=cfg.weight_decay)
        self.step = 0
        self._perm_cache = {}

    def lr(self, step: int) -> float:
        return warmup_cosine_lr(step, self.cfg.learning_rate, self.warmup,
                                self.decay_steps)

    def loss(self, tokens, loss_mask, count=None):
        if self.cfg.loss_chunk > 0:
            return chunked_completion_loss(self.model, tokens, loss_mask,
                                           self.cfg.loss_chunk, count)
        return completion_loss(self.model, tokens, loss_mask, count)

    def train_step(self, tokens, loss_mask):
        """One step on a batch already on the device (over a mesh: this dp
        rank's rows of the global batch); returns the loss of the global
        batch (a device scalar, read by the caller); ``grad_norm`` keeps
        the step's global gradient norm before the clip."""
        for p in self.params:
            p.grad = None
        mesh = self.mesh
        count = coll.all_reduce_(loss_mask[:, 1:].sum(), mesh.dp_group, mesh.dp)
        loss = self.loss(tokens, loss_mask, count)
        loss.backward()
        coll.sync_grads(mesh, [p.grad for p in self.replicated],
                        [p.grad for p in self.sharded], average_dp=False,
                        partial=[p.grad for p in self.partial])
        self.grad_norm = coll.clip_by_global_norm_(
            mesh, [p.grad for p in self.replicated + self.partial],
            [p.grad for p in self.sharded], self.cfg.grad_clip)
        loss = coll.all_reduce_(loss.detach().clone(), mesh.dp_group, mesh.dp)
        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.step)
        self.opt.step()
        self.step += 1
        return loss.detach()

    # ------------------------------------------------------------------
    def _batch_indices(self, N: int, step: int) -> np.ndarray:
        """Epoch-shuffled sampling without replacement: the example stream
        is the concatenation of per-epoch permutations, each from (seed,
        epoch), so a resumed run continues the same stream."""
        B = self.cfg.batch_size
        pos = step * B
        idx = np.empty(B, dtype=np.int64)
        got = 0
        while got < B:
            epoch, off = divmod(pos + got, N)
            perm = self._perm_cache.get((epoch, N))
            if perm is None:
                perm = np.random.default_rng((self.cfg.seed, epoch)).permutation(N)
                self._perm_cache[(epoch, N)] = perm
                for k in list(self._perm_cache)[:-2]:
                    del self._perm_cache[k]
            take = min(B - got, N - off)
            idx[got:got + take] = perm[off:off + take]
            got += take
        return idx

    def train(self, tokens: np.ndarray, loss_mask: np.ndarray,
              steps: Optional[int] = None, log_every: int = 50,
              resume: bool = True) -> List[float]:
        """tokens/loss_mask: [N, L] host arrays; epoch-shuffled batches.
        Returns the loss of every step run."""
        cfg = self.cfg
        if resume:
            self.maybe_resume()
        N = tokens.shape[0]
        steps = steps if steps is not None else cfg.total_steps
        losses = []
        while self.step < steps:
            idx = self._batch_indices(N, self.step)
            idx = idx[coll.batch_sharding(self.mesh, len(idx))]
            batch_tok = torch.from_numpy(tokens[idx]).to(self.device)
            batch_mask = torch.from_numpy(loss_mask[idx]).to(self.device)
            losses.append(float(self.train_step(batch_tok, batch_mask)))
            if self.step % log_every == 0 and self.mesh.rank == 0:
                print(f"step {self.step}: loss {np.mean(losses[-log_every:]):.4f}",
                      flush=True)
            if self.step % cfg.save_every == 0:
                self.save()
        return losses

    # ------------------------------------------------------------------
    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self.cfg.output_dir, f"checkpoint-{step}.pt")

    def save(self):
        """The whole model (over a mesh: gathered, written by rank 0)."""
        state = full_llm_state(self.model, self.mesh)
        if self.mesh.rank == 0:
            save_state(self._ckpt_path(self.step), state)
        coll.barrier(self.mesh)

    def last_checkpoint(self) -> Optional[int]:
        if not os.path.isdir(self.cfg.output_dir):
            return None
        steps = [int(m.group(1)) for name in os.listdir(self.cfg.output_dir)
                 if (m := re.fullmatch(r"checkpoint-(\d+)\.pt", name))]
        return max(steps) if steps else None

    def maybe_resume(self) -> bool:
        """Load the latest checkpoint's parameters and step, if any (the
        optimizer state starts afresh, as in the JAX trainer)."""
        last = self.last_checkpoint()
        if last is None:
            return False
        state = load_state(self._ckpt_path(last),
                           full_llm_state(self.model, self.mesh), partial=False)
        self.model.load_state_dict(local_llm_state(self.model, self.mesh, state))
        self.step = last
        return True


# ---------------------------------------------------------------- the CLI
def build_parser() -> argparse.ArgumentParser:
    """``--data`` files, one flag per field of SFTConfig and LlamaConfig
    (``--max_seq_len`` sets both), and ``--device``."""
    ap = argparse.ArgumentParser("python -m gnn_rag_tpu_torch.llm.sft")
    ap.add_argument("--data", nargs="+", required=True,
                    help="JSONL files with a 'text' field (finetune.data_prep)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    seen = set()
    for dc in (SFTConfig, LlamaConfig):
        for f in dataclasses.fields(dc):
            if f.name in seen:
                continue
            seen.add(f.name)
            typ = {"bool": bool_flag, "int": int, "float": float}.get(
                str(f.type), str)
            ap.add_argument(f"--{f.name}", type=typ, default=f.default)
    return ap


def main(argv=None):
    from ..finetune.data_prep import load_multiple_datasets
    from .tokenizers import ByteTokenizer

    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is false "
                           "(pass --device cpu to run on the CPU)")
    vals = vars(args)
    cfg = SFTConfig(**{f.name: vals[f.name] for f in dataclasses.fields(SFTConfig)})
    model_cfg = LlamaConfig(**{f.name: vals[f.name]
                               for f in dataclasses.fields(LlamaConfig)})
    tok = ByteTokenizer()
    data = load_multiple_datasets(args.data, shuffle=True, seed=cfg.seed)
    tokens, mask = pack_examples([d["text"] for d in data], tok.encode,
                                 tok.encode(RESPONSE_TEMPLATE, add_bos=False),
                                 cfg.max_seq_len, tok.pad_id)
    trainer = SFTTrainer(model_cfg, cfg, device=args.device)
    losses = trainer.train(tokens, mask, log_every=1)
    if trainer.step % cfg.save_every:
        trainer.save()
    return trainer, losses


if __name__ == "__main__":
    main()
