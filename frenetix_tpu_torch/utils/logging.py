"""Message logging: a file handler (messages.log) and a console handler.

The port's own copy of `frenetix_tpu/utils/logging.py`.  The console handler
is Rich's where `rich` imports, else a plain stream handler.  A logger that
already has handlers is returned as it is: a second `make_msg_logger` in one
process (a second `run_scenario.main`) keeps writing to the first
messages.log.
"""
from __future__ import annotations

import logging
import os

__all__ = ["make_msg_logger"]


def make_msg_logger(log_dir: str, name: str = "frenetix_tpu_torch",
                    level=logging.INFO):
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    logger.propagate = False

    os.makedirs(log_dir, exist_ok=True)
    fh = logging.FileHandler(os.path.join(log_dir, "messages.log"))
    fh.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)-8s %(message)s", "%H:%M:%S")
    )
    logger.addHandler(fh)

    try:
        from rich.logging import RichHandler

        logger.addHandler(RichHandler(show_path=False))
    except ImportError:
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(levelname)-8s %(message)s"))
        logger.addHandler(sh)
    return logger
