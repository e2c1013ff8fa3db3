"""The workflow's logger (reference: mmcv get_root_logger 'Flow-6D',
train.py:112-114): the port's copy of scflow_tpu/utils/logging.py."""

import logging
import os
from typing import Optional


def get_logger(name: str = "scflow_tpu_torch", log_file: Optional[str] = None,
               level=logging.INFO) -> logging.Logger:
    """A logger that writes "time - name - level - message" lines to stderr
    (and to log_file), set up once per name."""
    logger = logging.getLogger(name)
    if getattr(logger, "_scflow_configured", False):
        return logger
    logger.setLevel(level)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    handlers = [logging.StreamHandler()]
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger._scflow_configured = True
    return logger
