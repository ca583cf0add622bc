"""Trainer: epoch loop, global-norm clip + Adam with staircase exponential
decay, best-H1/F1 checkpoints, test evaluation and the `.info` export.

Port of ``gnn_rag_tpu.train.trainer`` (reference: gnn/train_model.py:24-253)
for one CUDA device (or the CPU, with the kernels' plain versions). A step is
forward in training mode, ``loss.backward()`` (the gate-scatter gradient in
its backward kernel), the clip, the learning rate of the step, and
``torch.optim.Adam``. Per-step metrics (loss, Hit@1, training F1) are summed
on the device; the epoch reads them once, at its end. Batch assembly runs
one batch ahead on a thread.

``build_model`` builds ReaRev, NSM or GraftNet for the inputs the Trainer
is given (``models.retriever``): the frozen-LM relation states, or none;
precomputed question states, or the in-model LM; the frozen entity, word and
relation tables. Those tables ride along on the device as frozen tensors.

With a ``mesh`` (``parallel.mesh.make_mesh``; one process a rank) the
Trainer runs data and tensor parallel as the JAX Trainer does over its
device mesh, with the numbers of one process: every rank builds the global
padded batch and takes its dp rows; the dropout masks are drawn for the
global batch (``models.encoders.RowShard``); large parameters are stored as
tp slices (``shard_params``); the gradients are averaged over dp (every
loss is a mean over the batch's padded rows, and every dp rank holds B/dp
of them), the clip's norm sums the tp slices; only rank 0 writes
checkpoints (whole), the `.info` and their sidecars. Without a mesh the
Trainer runs the same steps on a mesh of one rank (``local_mesh``), whose
collectives do nothing.

``profile_dir`` traces the first epoch (``utils.profiling.trace``: a
``torch.profiler`` Chrome trace into that directory).
"""

from __future__ import annotations

import json
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..data.loader import KGQADataset
from ..models.base import calc_h1
from ..models.encoders import RowShard, flax_like_init_
from ..parallel import collectives as coll
from ..parallel import mesh as pmesh
from ..utils.checkpoint import load_state, save_state
from .evaluate import Evaluator
from .metrics import train_f1_device


def build_model(cfg, num_entity: int, num_kb_relation: int, *,
                word_dim: Optional[int] = None, seed: int = 0, device="cuda",
                **inputs):
    """The retriever ``cfg.model.model_name`` names (ReaRev, NSM or
    GraftNet; gnn_rag_tpu/train/trainer.py:32-45) with flax-family random
    weights from ``seed``, on ``device``, in eval mode. ``word_dim`` and
    ``inputs`` say what the model is given (``models.retriever``)."""
    name = cfg.model.model_name
    if name == "ReaRev":
        from ..models.rearev import ReaRev as cls
    elif name == "NSM":
        from ..models.nsm import NSM as cls
    elif name == "GraftNet":
        from ..models.graftnet import GraftNet as cls
    else:
        raise ValueError(f"unknown model {name}")
    model = cls(cfg.model, num_entity, num_kb_relation, word_dim, **inputs)
    flax_like_init_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def model_inputs(cfg, *, q_hidden: bool, rel_hidden=None, entity_emb=None,
                 word_emb=None, relation_emb=None,
                 word_dim: Optional[int] = None, num_word: int = 0) -> dict:
    """The ``word_dim`` and ``inputs`` of ``build_model`` for these frozen
    arrays (None where not given): the frozen-LM width is ``rel_hidden``'s,
    else ``word_dim`` (that of the question states); without precomputed
    question states (``q_hidden`` False) a transformer ``lm`` runs in the
    model (gnn_rag_tpu/models/rearev.py:270-274)."""
    return dict(
        word_dim=word_dim if rel_hidden is None else rel_hidden.shape[-1],
        num_word=num_word, rel_text=rel_hidden is not None,
        inmodel_lm=cfg.model.lm != "lstm" and not q_hidden,
        word_emb_dim=None if word_emb is None else word_emb.shape[-1],
        entity_emb_dim=None if entity_emb is None else entity_emb.shape[-1],
        relation_emb_dim=None if relation_emb is None else relation_emb.shape[-1])


class Trainer:
    def __init__(self, cfg, *, train_data: Optional[KGQADataset],
                 valid_data: KGQADataset, test_data: KGQADataset,
                 num_entity: int, num_kb_relation: int, rel_hidden=None,
                 rel_hidden_inv=None, rel_text_mask=None,
                 word_dim: Optional[int] = None, num_word: int = 0,
                 entity_emb=None, word_emb=None, relation_emb=None,
                 id2entity: Optional[dict] = None, logger=None,
                 lm_source: Optional[str] = None, decode_question=None,
                 device="cuda", mesh: Optional[pmesh.Mesh] = None):
        """``rel_hidden``, ``rel_hidden_inv``, ``rel_text_mask``: the frozen
        LM's relation-text states and mask, or None (relation texts off);
        ``entity_emb``, ``word_emb``, ``relation_emb``: frozen tables, or
        None; ``word_dim``: the frozen LM's width where no ``rel_hidden``
        or question states tell it; ``num_word``: the LSTM's vocabulary;
        ``mesh``: run data/tensor parallel over it (on its device; None: one
        process on ``device``)."""
        tc = cfg.train
        self.cfg = cfg
        self.mesh = mesh = mesh or pmesh.local_mesh(device)
        self.device = mesh.device
        self.lm_source = lm_source
        # q_token_ids -> the `.info` "question" (None: the raw question)
        self.decode_question = decode_question
        self.train_data = train_data
        self.valid_data = valid_data
        self.test_data = test_data
        self.num_entity = num_entity
        # the model's frozen inputs, in the order of its forward
        self.rel_args = tuple(
            None if a is None else torch.as_tensor(np.asarray(a, np.float32),
                                                   device=self.device)
            for a in (rel_hidden, rel_hidden_inv, rel_text_mask, entity_emb,
                      word_emb, relation_emb))
        if logger is None:
            from ..utils.logging import create_logger
            logger = create_logger("trainer", tc.checkpoint_dir, config=cfg.model)
        self.logger = logger
        data = train_data or test_data
        q_hidden = bool(data is not None and data.q_hidden)
        if word_dim is None and q_hidden:
            word_dim = data.q_hidden[0].shape[-1]
        self.model = build_model(
            cfg, num_entity, num_kb_relation, seed=tc.seed, device=self.device,
            **model_inputs(cfg, q_hidden=q_hidden, rel_hidden=rel_hidden,
                           entity_emb=entity_emb, word_emb=word_emb,
                           relation_emb=relation_emb, word_dim=word_dim,
                           num_word=num_word))
        pmesh.replicate(mesh, self.model)
        pmesh.replicate(mesh, self.rel_args)
        self.sharded = pmesh.shard_params(mesh, self.model)
        # dropout masks and the epoch shuffles come from this generator (the
        # same draws on every rank of a mesh)
        self.generator = torch.Generator(device=self.device).manual_seed(tc.seed)

        # clip -> Adam with a staircase exponential decay per epoch
        # (train_model.py:89-94, 133-134)
        self.steps_per_epoch = max(1, math.ceil(
            (train_data.num_data if train_data else 1) / tc.batch_size))
        self._new_optimizer()
        num_iter = {"ReaRev": cfg.model.num_iter, "NSM": cfg.model.num_step,
                    "GraftNet": cfg.model.num_layer}[cfg.model.model_name]
        self.evaluator = Evaluator(eps=cfg.model.eps, num_entity=num_entity,
                                   id2entity=id2entity or {},
                                   num_iter=num_iter)
        self.best_h1 = 0.0
        self.best_f1 = 0.0
        self._prefetch = ThreadPoolExecutor(max_workers=1)

    def _new_optimizer(self):
        """Adam with fresh moments and the schedule at step 0 (optax's
        ``tx.init``)."""
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=self.cfg.train.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.step_count = 0

    def close(self):
        self._prefetch.shutdown()

    @property
    def is_writer(self) -> bool:
        """Whether this process writes files (rank 0 of a mesh)."""
        return self.mesh.rank == 0

    def seed_submodule(self, name: str, state_dict) -> None:
        """Overlay the submodule ``name`` (e.g. the in-model LM ``lm``) with
        loaded weights, then start the optimizer afresh
        (gnn_rag_tpu/train/trainer.py:346-371): the lm_frozen=0 path starts
        from the pretrained encoder and finetunes it (bert_encoder.py:80-83).
        Every tensor's shape must match."""
        sub = getattr(self.model, name, None)
        if sub is None:
            raise KeyError(f"model has no trainable submodule {name!r} "
                           "(is lm_frozen=0 and lm != lstm?)")
        own = {k[len(name) + 1:]: v for k, v in self.full_state().items()
               if k.startswith(name + ".")}
        for key, t in state_dict.items():
            if key in own and tuple(own[key].shape) != tuple(t.shape):
                raise ValueError(f"seed_submodule({name!r}): shape mismatch "
                                 f"{key} {tuple(own[key].shape)} vs "
                                 f"{tuple(t.shape)}")
        if set(own) != set(state_dict):
            raise KeyError(f"seed_submodule({name!r}): names differ: "
                           f"{sorted(set(own) ^ set(state_dict))}")
        pmesh.load_full_state_(self.model, {f"{name}.{k}": v
                                            for k, v in state_dict.items()})
        self._new_optimizer()

    def full_state(self):
        """The model's state_dict with whole tensors (every rank of a mesh
        must call it)."""
        return pmesh.full_state_dict(self.model)

    # ------------------------------------------------------------------ steps
    def learning_rate(self, step: int) -> float:
        """optax ``exponential_decay(lr, steps_per_epoch, decay_rate,
        staircase=True)`` at ``step`` (0 for the first step)."""
        tc = self.cfg.train
        if tc.decay_rate > 0:
            return tc.lr * tc.decay_rate ** (step // self.steps_per_epoch)
        return tc.lr

    def train_step(self, batch, valid_w: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
        """One optimisation step on a batch already on the device. ``acc``
        holds the running (loss, h1 . valid_w, f1 . valid_w, n) sums; returns
        them with this step's added. Nothing is read back to the host;
        ``grad_norm`` keeps the step's global gradient norm before the clip
        (a device scalar)."""
        mesh = self.mesh
        generator = RowShard(self.generator, mesh.dp, mesh.dp_rank,
                             batch.heads.shape[0])
        with torch.nn.utils.parametrize.cached():
            loss, _, pred_dist = self.model(batch, *self.rel_args,
                                            training=True, generator=generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        sharded = {id(p) for p in pmesh.sharded_params(self.model)}
        rep = [p.grad for p in self.model.parameters() if id(p) not in sharded]
        shd = [p.grad for p in self.model.parameters() if id(p) in sharded]
        coll.sync_grads(mesh, rep, shd, average_dp=True)
        self.grad_norm = coll.clip_by_global_norm_(
            mesh, rep, shd, self.cfg.train.gradient_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self.learning_rate(self.step_count)
        self.optimizer.step()
        self.step_count += 1
        with torch.no_grad():
            h1 = calc_h1(pred_dist, batch.answer_dist)
            f1 = train_f1_device(pred_dist, batch.answer_dist, h1,
                                 batch.entity_gids, batch.seed_dist,
                                 self.num_entity, self.cfg.model.eps)
            return acc + torch.stack([loss.detach(), h1 @ valid_w, f1 @ valid_w,
                                      valid_w.sum()])

    # ------------------------------------------------------------------ loops
    def train_epoch(self):
        """One epoch over a shuffled order. Returns (mean_loss, mean_h1,
        mean_f1) as floats; the only read from the device is the sums at the
        end."""
        tc = self.cfg.train
        data = self.train_data
        seed = int(torch.randint(2**31 - 1, (), generator=self.generator,
                                 device=self.device))
        data.reset_batches(is_sequential=False, rng=np.random.default_rng(seed),
                           bucket_size=tc.batch_size if tc.bucket_batches else None)
        num_batches = math.ceil(data.num_data / tc.batch_size)
        if num_batches == 0:
            return 0.0, 0.0, 0.0

        mesh = self.mesh

        def build(it):
            # the global padded batch; a mesh rank takes its dp rows of it
            idx = data.batch_indices(it, tc.batch_size)
            batch = data.make_batch(idx, batch_pad_to=tc.batch_size)
            valid_w = np.zeros(tc.batch_size, np.float32)
            valid_w[:len(idx)] = 1.0
            return (pmesh.shard_batch(mesh, batch),
                    valid_w[pmesh.batch_sharding(mesh, tc.batch_size)])

        acc = torch.zeros(4, device=self.device)
        fut = self._prefetch.submit(build, 0)
        for it in range(num_batches):
            batch, valid_w = fut.result()
            if it + 1 < num_batches:
                fut = self._prefetch.submit(build, it + 1)
            acc = self.train_step(batch.to(self.device),
                                  torch.from_numpy(valid_w).to(self.device), acc)
        # sums over dp; each step's loss is the dp mean of the ranks'
        coll.all_reduce_(acc, mesh.dp_group, mesh.dp)
        acc[0] /= mesh.dp
        loss_sum, h1_sum, f1_sum, n = acc.tolist()
        n = max(n, 1.0)
        return loss_sum / num_batches, h1_sum / n, f1_sum / n

    def forward(self, batch):
        """(loss, pred, pred_dist) of a numpy GraphBatch, eval mode (over a
        mesh: of the global batch, each rank running its dp rows)."""
        return pmesh.sharded_forward(self.mesh, self.model, batch,
                                     self.rel_args)

    def attn_forward(self, batch):
        """(loss, pred, pred_dist, instruction attention [B, J, L]) of a
        numpy GraphBatch, eval mode (ReaRev and NSM)."""
        return pmesh.sharded_forward(self.mesh, self.model, batch,
                                     self.rel_args, return_attn=True)

    def evaluate(self, data: KGQADataset, test_batch_size: Optional[int] = None,
                 write_info: bool = False, info_path: Optional[str] = None,
                 write_attention: bool = False):
        """(f1, h1, em) of ``data``; optionally writes the `.info` file, with
        ``write_attention`` the instruction attention in its slots."""
        # GraftNet has no instruction attention: its slots stay empty
        attn = (self.attn_forward if write_attention
                and self.cfg.model.model_name != "GraftNet" else None)
        bs = test_batch_size or self.cfg.train.test_batch_size
        f1, h1, em, _ = self.evaluator.evaluate(
            data, self.forward, bs, write_info=write_info,
            info_path=info_path if self.is_writer else None,
            decode_question=self.decode_question, attn_forward_fn=attn,
            batch_pad_to=bs if self.mesh.dp > 1 else None)
        return f1, h1, em

    def train(self, start_epoch: int = 0, end_epoch: Optional[int] = None):
        """Epochs ``start_epoch..end_epoch`` with dev/test evaluation every
        ``eval_every``, best-h1/f1 and final checkpoints, then the test
        metrics of each checkpoint. Returns each epoch's (loss, h1, f1)."""
        tc = self.cfg.train
        end_epoch = tc.num_epoch - 1 if end_epoch is None else end_epoch
        history = []
        for epoch in range(start_epoch, end_epoch + 1):
            st = time.time()
            if epoch == start_epoch and tc.profile_dir:
                from ..utils.profiling import trace
                with trace(tc.profile_dir, self.device):
                    loss, h1, f1 = self.train_epoch()
                self.logger.info("profiler trace written to %s", tc.profile_dir)
            else:
                loss, h1, f1 = self.train_epoch()
            history.append((loss, h1, f1))
            self.logger.info("Epoch: %d, loss: %.4f, time: %.1fs",
                             epoch + 1, loss, time.time() - st)
            self.logger.info("Training h1: %.4f, f1: %.4f", h1, f1)
            if (epoch + 1) % tc.eval_every == 0:
                eval_f1, eval_h1, eval_em = self.evaluate(self.valid_data)
                self.logger.info("EVAL F1: %.4f, H1: %.4f, EM: %.4f",
                                 eval_f1, eval_h1, eval_em)
                if epoch > tc.warmup_epoch:
                    if eval_h1 > self.best_h1:
                        self.best_h1 = eval_h1
                        self.save_ckpt("h1")
                    if eval_f1 > self.best_f1:
                        self.best_f1 = eval_f1
                        self.save_ckpt("f1")
                test_f1, test_h1, test_em = self.evaluate(self.test_data)
                self.logger.info("TEST F1: %.4f, H1: %.4f, EM: %.4f",
                                 test_f1, test_h1, test_em)
        self.save_ckpt("final")
        self.evaluate_best()
        return history

    def evaluate_best(self):
        """Test metrics of each checkpoint written (h1, f1, final); the model
        ends with the last one loaded."""
        for reason in ("h1", "f1", "final"):
            path = self._ckpt_path(reason)
            if not os.path.exists(path):
                continue
            self.load_ckpt(path)
            f1, h1, em = self.evaluate(self.test_data)
            self.logger.info("Best %s evaluation — TEST F1: %.4f, H1: %.4f, "
                             "EM: %.4f", reason, f1, h1, em)

    def evaluate_single(self, ckpt_path: Optional[str] = None,
                        info_path: Optional[str] = None,
                        write_attention: bool = False):
        """Eval-only entry (train_model.py:201-207): dev metrics, then the
        test `.info` with its `.meta.json` provenance sidecar."""
        if ckpt_path:
            self.load_ckpt(ckpt_path)
        ev = self.evaluate(self.valid_data)
        self.logger.info("EVAL F1: %.4f, H1: %.4f, EM: %.4f", *ev)
        info_path = info_path or os.path.join(
            self.cfg.train.checkpoint_dir,
            f"{self.cfg.train.experiment_name}_test.info")
        # a sidecar, not a header line: the LLM half reads .info by line order
        if self.is_writer:
            self._write_provenance(info_path + ".meta.json")
        te = self.evaluate(self.test_data, write_info=True, info_path=info_path,
                           write_attention=write_attention)
        self.logger.info("TEST F1: %.4f, H1: %.4f, EM: %.4f", *te)
        return ev, te

    # ------------------------------------------------------------------ ckpts
    def _ckpt_path(self, reason: str) -> str:
        return os.path.join(self.cfg.train.checkpoint_dir,
                            f"{self.cfg.train.experiment_name}-{reason}.ckpt")

    def save_ckpt(self, reason: str = "h1"):
        """The whole model (a mesh gathers the tp slices; rank 0 writes and
        the others wait for it)."""
        path = self._ckpt_path(reason)
        state = self.full_state()
        if self.is_writer:
            save_state(path, state)
            self._write_provenance(path + ".meta.json")
        coll.barrier(self.mesh)
        self.logger.info("Best %s, saved model as %s", reason, path)

    def _write_provenance(self, path: str):
        meta = {"experiment_name": self.cfg.train.experiment_name,
                "model": self.cfg.model.model_name,
                "lm": self.cfg.model.lm,
                "lm_weight_source": self.lm_source or "unspecified"}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(meta, f, indent=1)

    def load_ckpt(self, path: str):
        """Partial load (the reference's strict=False, train_model.py:252):
        tensors whose name and shape match are taken, the rest kept."""
        pmesh.load_full_state_(self.model,
                               load_state(path, self.full_state(), partial=True),
                               partial=True)
