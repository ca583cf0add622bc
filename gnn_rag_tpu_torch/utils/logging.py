"""File + stream logger dumping all config at start
(reference: gnn/utils.py:5-36). Copy of ``gnn_rag_tpu.utils.logging``."""

from __future__ import annotations

import dataclasses
import logging
import os
import sys


def create_logger(name: str, log_dir: str | None = None,
                  level: str = "info", config=None) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"{name}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if config is not None:
        if dataclasses.is_dataclass(config):
            config = dataclasses.asdict(config)
        for k in sorted(config):
            logger.info("config %s = %s", k, config[k])
    return logger
