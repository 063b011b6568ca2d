"""Logging setup of the CLI; port of ``setup_logging`` from
``shadow_removal_istd_tpu/utils/logging_utils.py`` (the reference's
src/main.py:68-85 format)."""

from __future__ import annotations

import logging
import os


def setup_logging(log_file: str | None = None,
                  level: int = logging.INFO) -> None:
    """File + console logging with the reference's format."""
    fmt = logging.Formatter(
        "%(asctime)s [%(module)s::%(funcName)s] %(levelname)s: %(message)s",
        datefmt="%H:%M:%S")
    root = logging.getLogger()
    root.setLevel(level)
    if log_file:
        log_dir = os.path.dirname(log_file)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    handler = logging.StreamHandler()
    handler.setFormatter(fmt)
    root.addHandler(handler)
