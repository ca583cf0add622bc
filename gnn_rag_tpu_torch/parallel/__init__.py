"""Scale-out over ``torch.distributed``: ``collectives`` (the mesh and its
collectives, shared by the retriever and the LLM reader) and ``mesh`` (the
retriever's batch, parameter and forward sharding)."""
