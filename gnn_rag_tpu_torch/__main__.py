"""``python -m gnn_rag_tpu_torch <Model> --flags``: see ``cli``."""

from .cli import run

if __name__ == "__main__":
    run()
