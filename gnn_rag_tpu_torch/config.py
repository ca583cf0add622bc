"""Configuration of the port: the JAX package's framework-free config
dataclasses (``gnn_rag_tpu.config``, the typed form of the reference CLI
flags), shared so that both packages read one configuration."""

from gnn_rag_tpu.config import Config, DataConfig, ModelConfig, TrainConfig

__all__ = ["Config", "DataConfig", "ModelConfig", "TrainConfig"]
