"""Question / relation-text tokenizers.

Three interchangeable tokenizers behind one protocol (`encode(texts, max_len)
-> (ids[N, max_len], pad_id)`):

* ``LSTMWordTokenizer`` — whitespace split against vocab.txt, pad id =
  len(word2id) (reference: gnn/modules/question_encoding/tokenizers.py +
  dataset_load.py:184-187).
* ``HFTokenizer`` — a HuggingFace AutoTokenizer by LM name (reference:
  dataset_load.py:188-211). Requires the tokenizer files to be available
  locally; raises otherwise.
* ``HashTokenizer`` — deterministic hashing tokenizer for offline tests and
  synthetic benchmarks (new; no reference counterpart).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

HF_TOKENIZER_NAMES = {
    # reference: dataset_load.py:189-204, bert_encoder.py:30-59
    "bert": "bert-base-uncased",
    "roberta": "roberta-base",
    "sbert": "sentence-transformers/all-MiniLM-L6-v2",
    "sbert2": "sentence-transformers/all-mpnet-base-v2",
    "simcse": "princeton-nlp/sup-simcse-bert-base-uncased",
    "t5": "t5-small",
    "relbert": "pretrained_lms/sr-simbert/",
}


class LSTMWordTokenizer:
    def __init__(self, word2id):
        self.word2id = word2id
        self.pad_id = len(word2id)

    def encode(self, texts: Sequence[str], max_len: int) -> np.ndarray:
        out = np.full((len(texts), max_len), self.pad_id, dtype=np.int32)
        for i, t in enumerate(texts):
            for j, w in enumerate(t.split(" ")[:max_len]):
                out[i, j] = self.word2id.get(w, self.pad_id)
        return out


class HFTokenizer:
    def __init__(self, lm: str):
        from transformers import AutoTokenizer
        self.tok = AutoTokenizer.from_pretrained(HF_TOKENIZER_NAMES[lm],
                                                 local_files_only=True)
        self.pad_id = self.tok.convert_tokens_to_ids(self.tok.pad_token)

    def encode(self, texts: Sequence[str], max_len: int) -> np.ndarray:
        enc = self.tok(list(texts), max_length=max_len, padding="max_length",
                       truncation=True, return_attention_mask=False)
        return np.asarray(enc["input_ids"], dtype=np.int32)


class HashTokenizer:
    """Stable fallback: token id = sha1(word) % (vocab_size - reserved)."""

    CLS = 1
    SEP = 2

    def __init__(self, vocab_size: int = 30522, pad_id: int = 0):
        self.vocab_size = vocab_size
        self.pad_id = pad_id

    def _tid(self, w: str) -> int:
        import hashlib
        h = int(hashlib.sha1(w.encode()).hexdigest()[:8], 16)
        return 3 + h % (self.vocab_size - 3)

    def encode(self, texts: Sequence[str], max_len: int) -> np.ndarray:
        out = np.full((len(texts), max_len), self.pad_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids: List[int] = [self.CLS] + [self._tid(w) for w in t.split()][: max_len - 2] + [self.SEP]
            out[i, : len(ids)] = ids
        return out


def make_tokenizer(lm: str, word2id=None, allow_fallback: bool = True):
    """Pick a tokenizer for the configured LM, falling back to HashTokenizer
    when HF assets are unavailable (offline)."""
    if lm == "lstm":
        assert word2id is not None, "lstm tokenizer needs word2id"
        return LSTMWordTokenizer(word2id)
    try:
        return HFTokenizer(lm)
    except Exception:
        if allow_fallback:
            return HashTokenizer()
        raise
