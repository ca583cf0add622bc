"""Vocabulary loading (reference: gnn/dataset_load.py:632-658)."""

from __future__ import annotations

from typing import Dict


def load_dict(filename: str) -> Dict[str, int]:
    """One token per line -> id = line number (dataset_load.py:632-638)."""
    out: Dict[str, int] = {}
    with open(filename, encoding="utf-8") as f:
        for line in f:
            out[line.strip()] = len(out)
    return out


def load_dict_int(filename: str) -> Dict[int, int]:
    """Identity int map used by the 'sr-cwq' layout (dataset_load.py:640-646)."""
    out: Dict[int, int] = {}
    with open(filename, encoding="utf-8") as f:
        for line in f:
            v = int(line.strip())
            out[v] = v
    return out


class Vocab:
    """Entity / relation / word vocabularies for one dataset directory."""

    def __init__(self, entity2id, relation2id, word2id):
        self.entity2id = entity2id
        self.relation2id = relation2id
        self.word2id = word2id
        self.id2entity = {i: e for e, i in entity2id.items()}
        self.id2relation = {i: r for r, i in relation2id.items()}

    @property
    def num_entity(self) -> int:
        return len(self.entity2id)

    @property
    def num_relation(self) -> int:
        return len(self.relation2id)

    @classmethod
    def from_dir(cls, folder: str, entity_file="entities.txt",
                 relation_file="relations.txt", word_file="vocab.txt") -> "Vocab":
        import os
        loader = load_dict_int if "sr-cwq" in folder else load_dict
        entity2id = loader(os.path.join(folder, entity_file))
        relation2id = load_dict(os.path.join(folder, relation_file))
        word_path = os.path.join(folder, word_file)
        word2id = load_dict(word_path) if os.path.exists(word_path) else {}
        return cls(entity2id, relation2id, word2id)
