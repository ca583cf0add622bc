"""Asset-free tokenizers of the LLM reader: copies of ``ByteTokenizer`` and
``WordTokenizer`` (gnn_rag_tpu/rag/llms/llama_tpu.py:22-107). The HF LLaMA
tokenizer waits until a checkpoint's files are on the machine."""

from __future__ import annotations

import json
from typing import List


class ByteTokenizer:
    """Reversible byte-level tokenizer: ids 0..2 = pad/bos/eos, 3..258 =
    bytes. No assets, no OOV."""

    pad_id = 0
    bos_id = 1
    eos_id = 2
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids) -> str:
        return bytes(max(0, int(i) - 3) for i in ids
                     if int(i) >= 3).decode("utf-8", errors="ignore")


class WordTokenizer:
    """Closed-vocabulary word tokenizer: text splits into `\\S+` words and
    whitespace runs; each in-vocab chunk is ONE token, out-of-vocab chunks
    fall back to byte tokens (ids 3..258, same as ByteTokenizer — fully
    reversible). Built from the KG vocabulary (entities/relations) plus the
    prompt-template words, so an entity id like `m.0005658` is a single
    token — which is what a real LLaMA BPE gives frequent surface forms,
    and what makes answer copying a one-token induction step instead of a
    9-byte transcription (the byte-level reader plateaued at 1.07 nats/byte
    and copied nothing)."""

    pad_id = 0
    bos_id = 1
    eos_id = 2
    _BYTE0 = 3          # ids 3..258 = byte fallback
    _WORD0 = 259        # word ids start here

    def __init__(self, words):
        self.words = list(words)
        self.vocab = {w: self._WORD0 + i for i, w in enumerate(self.words)}
        self.vocab_size = self._WORD0 + len(self.words)

    @classmethod
    def from_texts(cls, texts):
        import re
        seen, order = set(), []
        for t in texts:
            for chunk in re.findall(r"\S+|\s+", t):
                if chunk not in seen:
                    seen.add(chunk)
                    order.append(chunk)
        return cls(order)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.words, f)

    @classmethod
    def load(cls, path: str):
        with open(path) as f:
            return cls(json.load(f))

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        import re
        ids = [self.bos_id] if add_bos else []
        for chunk in re.findall(r"\S+|\s+", text):
            tid = self.vocab.get(chunk)
            if tid is not None:
                ids.append(tid)
            else:
                ids.extend(b + self._BYTE0 for b in chunk.encode("utf-8"))
        return ids

    def decode(self, ids) -> str:
        out, byte_run = [], bytearray()
        for i in ids:
            i = int(i)
            if i >= self._WORD0:
                if byte_run:
                    out.append(byte_run.decode("utf-8", errors="ignore"))
                    byte_run = bytearray()
                if i - self._WORD0 < len(self.words):
                    out.append(self.words[i - self._WORD0])
            elif i >= self._BYTE0:
                byte_run.append(i - self._BYTE0)
        if byte_run:
            out.append(byte_run.decode("utf-8", errors="ignore"))
        return "".join(out)
