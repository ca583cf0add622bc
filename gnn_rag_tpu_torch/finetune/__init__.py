"""Part of gnn_rag_tpu_torch; see the package docstring."""
