"""Greedy, beam-search and speculative decoding of the LLM reader with a kv
cache, the port of ``Decoder.greedy_batch`` / ``greedy`` /
``beam_search_batch`` / ``beam_search`` and ``SpeculativeDecoder``
(gnn_rag_tpu/llm_tpu/generate.py).

Prompts are batched LEFT-padded so every row's last prompt token sits at the
same cache slot; RoPE positions count each row's real tokens, and a kv-slot
validity mask keeps the pads out of attention. The prefill and every step
run the model with a cache and ``kv_valid``, so attention takes the plain
path (the flash kernels are for cache-free forwards). The loop runs on the
host, one forward per new token; greedy stops once every row has emitted
``eos_id``.

Beam search is what rag.gen_rule_path takes from HF ``generate``
(reference: llm/src/qa_prediction/gen_rule_path.py:71-99): N beams sharing
the prompt's cache, N returned sequences, each scored by its summed log-prob
over its generated length (eos included; HF's ``sequences_scores`` with
length_penalty 1.0), plus the softmax-normalised scores. Where the JAX code
takes ``lax.top_k``, which returns equal values lowest index first, this
takes a stable descending sort (``_top_k``), so ties break the same way.

``SpeculativeDecoder`` is greedy draft-and-verify for one prompt: a draft
model proposes ``gamma`` tokens from its own cache, the target scores them
in one chunk forward of gamma + 1 positions, and the longest agreeing
prefix is kept plus the target's own next token, so the output is the
target's greedy continuation.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .model import LlamaLM

NEG_INF = -1e30


def _left_pad(prompts: List[List[int]], pad_to_multiple: int = 32,
              pad_id: int = 0, budget: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad a ragged prompt batch -> (tokens [B, L], mask [B, L]); L
    rounds up to a multiple of ``pad_to_multiple`` unless that would exceed
    ``budget`` (max_len - max_new_tokens)."""
    L = max(len(p) for p in prompts)
    Lb = -(-L // pad_to_multiple) * pad_to_multiple
    L = Lb if budget is None or Lb <= budget else L
    B = len(prompts)
    toks = np.full((B, L), pad_id, np.int32)
    mask = np.zeros((B, L), np.float32)
    for i, p in enumerate(prompts):
        toks[i, L - len(p):] = p
        mask[i, L - len(p):] = 1.0
    return toks, mask


class Decoder:
    """Batched kv-cache greedy and beam-search decoder over a ``LlamaLM``
    (on its device)."""

    def __init__(self, model: LlamaLM, max_len: int = 512):
        self.model = model
        self.max_len = max_len
        self.device = model.tok_emb.weight.device

    def prefill(self, tokens, mask):
        """Run the left-padded prompt batch through a fresh cache ->
        (logits [B, L, V], caches, kv_valid [B, max_len])."""
        B, L = tokens.shape
        caches = self.model.init_kv_cache(B, self.max_len)
        positions = ((torch.cumsum(mask, dim=1) - 1.0) * mask).long()  # pads -> 0
        kv_valid = torch.zeros((B, self.max_len), device=self.device)
        kv_valid[:, :L] = mask
        logits, caches = self.model(tokens, positions=positions,
                                    kv_caches=caches, cache_index=0,
                                    kv_valid=kv_valid)
        return logits, caches, kv_valid

    @torch.no_grad()
    def _greedy(self, tokens, mask, max_new: int, eos_id: int) -> np.ndarray:
        B, L = tokens.shape
        logits, caches, kv_valid = self.prefill(tokens, mask)
        true_len = mask.sum(dim=1).long()
        cur = logits[:, -1].argmax(dim=-1)
        out = torch.zeros((B, max_new), dtype=torch.long, device=self.device)
        out[:, 0] = cur
        done = cur == eos_id
        for i in range(1, max_new):
            if bool(done.all()):
                break
            slot = L + i - 1
            kv_valid[:, slot] = 1.0
            step_logits, caches = self.model(
                cur[:, None], positions=(true_len + i - 1)[:, None],
                kv_caches=caches, cache_index=slot, kv_valid=kv_valid)
            nxt = step_logits[:, -1].argmax(dim=-1)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            out[:, i] = nxt
            done = done | (nxt == eos_id)
            cur = nxt
        return out.cpu().numpy()

    def greedy_batch(self, prompts: List[List[int]], max_new_tokens: int = 128,
                     eos_id: Optional[int] = None) -> List[List[int]]:
        toks, mask = _left_pad(prompts, budget=self.max_len - max_new_tokens)
        if toks.shape[1] + max_new_tokens > self.max_len:
            raise ValueError(f"prompt length {toks.shape[1]} + {max_new_tokens} "
                             f"new tokens exceeds max_len {self.max_len}")
        out = self._greedy(torch.from_numpy(toks).long().to(self.device),
                           torch.from_numpy(mask).to(self.device),
                           max_new_tokens, -1 if eos_id is None else eos_id)
        res = []
        for row in out:
            seq = row.tolist()
            if eos_id is not None and eos_id in seq:
                seq = seq[: seq.index(eos_id) + 1]
            res.append(seq)
        return res

    def greedy(self, prompt_tokens: List[int], max_new_tokens: int = 128,
               eos_id: Optional[int] = None) -> List[int]:
        return self.greedy_batch([prompt_tokens], max_new_tokens, eos_id)[0]

    # ------------------------------------------------------------- beam
    @torch.no_grad()
    def _beam(self, tokens, mask, num_beams: int, max_new: int, eos_id: int):
        B, L = tokens.shape
        K = num_beams
        V = self.model.cfg.vocab_size
        logits, caches, kv_valid = self.prefill(tokens, mask)
        true_len = mask.sum(dim=1).long()

        lp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)
        beam_scores, first = _top_k(lp0, K)                   # [B, K]
        beam_toks = torch.zeros((B, K, max_new), dtype=torch.long,
                                device=self.device)
        beam_toks[:, :, 0] = first

        # beams share the prompt cache: repeat rows K times -> [B*K, ...]
        caches = [(k.repeat_interleave(K, dim=0), v.repeat_interleave(K, dim=0))
                  for k, v in caches]
        kv_valid = kv_valid.repeat_interleave(K, dim=0)
        true_rep = true_len.repeat_interleave(K, dim=0)

        fin_scores = torch.full((B, K), NEG_INF, device=self.device)
        fin_toks = torch.zeros((B, K, max_new), dtype=torch.long,
                               device=self.device)
        fin_lens = torch.ones((B, K), dtype=torch.long, device=self.device)
        batch_idx = torch.arange(B, device=self.device)[:, None]
        rank_ok = torch.arange(2 * K, device=self.device)[None, :] < K

        for i in range(1, max_new):
            slot = L + i - 1
            kv_valid[:, slot] = 1.0
            step_logits, caches = self.model(
                beam_toks[:, :, i - 1].reshape(B * K, 1),
                positions=(true_rep + i - 1)[:, None], kv_caches=caches,
                cache_index=slot, kv_valid=kv_valid)
            lp = torch.log_softmax(step_logits[:, -1].float(), dim=-1)
            cand = beam_scores[:, :, None] + lp.reshape(B, K, V)
            top_s, top_i = _top_k(cand.reshape(B, K * V), 2 * K)
            tok = top_i % V                                   # [B, 2K]
            src = top_i // V
            is_eos = tok == eos_id

            # candidate buffers: the source beam's tokens with position i set
            cand_toks = beam_toks[batch_idx, src].clone()     # [B, 2K, T]
            cand_toks[:, :, i] = tok

            # finished hypotheses: eos candidates ranked < K (HF's beam
            # rule), normalised by the generated length (eos included)
            eos_norm = torch.where(is_eos & rank_ok, top_s / (i + 1.0),
                                   torch.full_like(top_s, NEG_INF))
            all_s = torch.cat([fin_scores, eos_norm], dim=1)
            all_t = torch.cat([fin_toks, cand_toks], dim=1)
            all_l = torch.cat([fin_lens, torch.full_like(tok, i + 1)], dim=1)
            fin_scores, keep = _top_k(all_s, K)
            fin_toks = all_t[batch_idx, keep]
            fin_lens = all_l[batch_idx, keep]

            # continuing beams: the best K candidates that are not eos
            cont_s = torch.where(is_eos, torch.full_like(top_s, NEG_INF), top_s)
            beam_scores, pick = _top_k(cont_s, K)             # [B, K]
            src_k = torch.gather(src, 1, pick)
            beam_toks = cand_toks[batch_idx, pick]
            flat_src = (batch_idx * K + src_k).reshape(-1)
            caches = [(k[flat_src], v[flat_src]) for k, v in caches]

        # finalize: running beams enter at length max_new (HF's rule)
        all_s = torch.cat([fin_scores, beam_scores / max_new], dim=1)
        all_t = torch.cat([fin_toks, beam_toks], dim=1)
        all_l = torch.cat([fin_lens, torch.full_like(fin_lens, max_new)], dim=1)
        out_s, keep = _top_k(all_s, K)
        return (all_t[batch_idx, keep].cpu().numpy(),
                all_l[batch_idx, keep].cpu().numpy(),
                out_s.cpu().numpy().astype(np.float64))

    def beam_search_batch(self, prompts: List[List[int]], num_beams: int = 3,
                          max_new_tokens: int = 128,
                          eos_id: Optional[int] = None
                          ) -> List[Tuple[List[List[int]], np.ndarray,
                                          np.ndarray]]:
        """Per prompt: (num_beams sequences of new tokens, their scores
        sorted best first, the scores' softmax)."""
        toks, mask = _left_pad(prompts, budget=self.max_len - max_new_tokens)
        if toks.shape[1] + max_new_tokens > self.max_len:
            raise ValueError(f"prompt length {toks.shape[1]} + {max_new_tokens} "
                             f"new tokens exceeds max_len {self.max_len}")
        out_t, out_l, out_s = self._beam(
            torch.from_numpy(toks).long().to(self.device),
            torch.from_numpy(mask).to(self.device), num_beams, max_new_tokens,
            -1 if eos_id is None else eos_id)
        res = []
        for b in range(len(prompts)):
            seqs = [out_t[b, k, : out_l[b, k]].tolist()
                    for k in range(num_beams)]
            scores = out_s[b]
            e = np.exp(scores - scores.max())
            res.append((seqs, scores, e / e.sum()))
        return res

    def beam_search(self, prompt_tokens: List[int], num_beams: int = 3,
                    max_new_tokens: int = 128, eos_id: Optional[int] = None
                    ) -> Tuple[List[List[int]], np.ndarray, np.ndarray]:
        return self.beam_search_batch([prompt_tokens], num_beams,
                                      max_new_tokens, eos_id)[0]


class SpeculativeDecoder:
    """Greedy speculative decoding of one prompt with a ``draft`` model
    (the same vocabulary) for a ``target``; ``greedy`` returns what
    ``Decoder(target).greedy`` returns, and sets ``last_stats``
    (``target_forwards``: the verify forwards + the prefill,
    ``draft_accepted``, ``tokens``). The loop runs on the host."""

    def __init__(self, target: LlamaLM, draft: LlamaLM, max_len: int = 512,
                 gamma: int = 4):
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError(f"draft vocabulary {draft.cfg.vocab_size} is not "
                             f"the target's {target.cfg.vocab_size}")
        if gamma < 1:
            raise ValueError(f"gamma {gamma}: speculation needs at least one "
                             f"draft token")
        self.target, self.draft = target, draft
        self.max_len = max_len
        self.gamma = int(gamma)
        self.device = target.tok_emb.weight.device

    def _chunk_forward(self, model, caches, tokens, start: int):
        """Forward tokens [1, C] at cache slots [start, start + C); every
        slot up to this chunk's last is valid."""
        C = tokens.shape[1]
        positions = (start + torch.arange(C, device=self.device))[None, :]
        kv_valid = (torch.arange(self.max_len, device=self.device)[None, :]
                    < start + C).float()
        return model(tokens, positions=positions, kv_caches=caches,
                     cache_index=start, kv_valid=kv_valid)

    @torch.no_grad()
    def _run(self, tokens, max_new: int, eos_id: int):
        """tokens [1, L], the prompt without padding -> (emitted ids,
        verify forwards, accepted draft tokens)."""
        L, gamma = tokens.shape[1], self.gamma
        caches_t = self.target.init_kv_cache(1, self.max_len)
        caches_d = self.draft.init_kv_cache(1, self.max_len)
        logits_t, caches_t = self._chunk_forward(self.target, caches_t, tokens, 0)
        _, caches_d = self._chunk_forward(self.draft, caches_d, tokens, 0)
        cur = int(logits_t[0, -1].argmax())
        out, done, n_fwd, n_acc = [cur], cur == eos_id, 0, 0
        # invariant: the last accepted token ``cur`` sits at slot
        # L + len(out) - 1 and is in neither cache yet
        while len(out) < max_new and not done:
            s = L + len(out) - 1
            # the draft proposes gamma tokens; one more step (its prediction
            # thrown away) puts the last draft token in the draft's cache,
            # so a round that accepts every draft leaves no hole
            drafts, d_cur = [], cur
            for g in range(gamma + 1):
                lg, caches_d = self._chunk_forward(
                    self.draft, caches_d,
                    torch.tensor([[d_cur]], device=self.device), s + g)
                d_cur = int(lg[0, -1].argmax())
                drafts.append(d_cur)
            drafts = drafts[:gamma]
            # the target checks the run in one chunk forward
            chunk = torch.tensor([[cur] + drafts], device=self.device)
            lg_t, caches_t = self._chunk_forward(self.target, caches_t, chunk, s)
            preds = lg_t[0].argmax(dim=-1).tolist()          # gamma + 1
            k = next((i for i in range(gamma) if preds[i] != drafts[i]), gamma)
            # drafts[:k] and the target's token after them, up to an eos
            emitted = drafts[:k] + [preds[k]]
            if eos_id in emitted:
                emitted = emitted[:emitted.index(eos_id) + 1]
                done = True
            out += emitted
            cur = emitted[-1]
            n_fwd, n_acc = n_fwd + 1, n_acc + k
        return out, n_fwd, n_acc

    def greedy(self, prompt_tokens: List[int], max_new_tokens: int = 128,
               eos_id: Optional[int] = None) -> List[int]:
        L = len(prompt_tokens)
        if L + max_new_tokens + self.gamma + 1 > self.max_len:
            raise ValueError(f"prompt length {L} + {max_new_tokens} new tokens "
                             f"+ gamma {self.gamma} + 1 exceeds max_len "
                             f"{self.max_len}")
        toks = torch.tensor([prompt_tokens], dtype=torch.long, device=self.device)
        out, n_fwd, n_acc = self._run(toks, max_new_tokens,
                                      -1 if eos_id is None else eos_id)
        seq = out[:max_new_tokens]
        if eos_id is not None and eos_id in seq:
            seq = seq[: seq.index(eos_id) + 1]
        self.last_stats = {"target_forwards": n_fwd + 1,
                           "draft_accepted": n_acc, "tokens": len(seq)}
        return seq


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, equal values
    lowest index first (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
