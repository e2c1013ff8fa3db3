"""The workflow's logger (reference: mmcv get_root_logger 'Flow-6D',
train.py:112-114): the port's copy of scflow_tpu/utils/logging.py."""

import logging
import os
import time
from typing import Optional


def get_logger(name: str = "scflow_tpu_torch", log_file: Optional[str] = None,
               level=logging.INFO) -> logging.Logger:
    """A logger that writes "time - name - level - message" lines to stderr,
    set up once per name, and to log_file when one is given: a new log_file
    replaces the file this logger wrote before (one file per run of a
    process that trains more than once)."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if not getattr(logger, "_scflow_configured", False):
        logger.setLevel(level)
        logger.propagate = False
        stream = logging.StreamHandler()
        stream.setFormatter(fmt)
        logger.addHandler(stream)
        logger._scflow_configured = True
    if log_file:
        path = os.path.abspath(log_file)
        files = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
        if [h.baseFilename for h in files] != [path]:
            for h in files:
                logger.removeHandler(h)
                h.close()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            handler = logging.FileHandler(path)
            handler.setFormatter(fmt)
            logger.addHandler(handler)
    return logger


def timestamped_log_file(work_dir: str) -> str:
    """work_dir/YYYYmmdd_HHMMSS.log."""
    return os.path.join(work_dir, time.strftime("%Y%m%d_%H%M%S", time.localtime()) + ".log")
