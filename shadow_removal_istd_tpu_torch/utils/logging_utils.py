"""Logging setup of the CLI; port of ``setup_logging`` from
``shadow_removal_istd_tpu/utils/logging_utils.py`` (the reference's
src/main.py:68-85 format)."""

from __future__ import annotations

import logging
import os


def setup_logging(log_file: str | None = None,
                  level: int = logging.INFO, rank: int | None = None) -> None:
    """File + console logging with the reference's format; with
    ``rank`` (a data-parallel run) each line starts ``[rank N]``. Each
    rank of such a run logs to a file of its own: the CLI names rank N's
    ``main-<time>-p<N>.log``, as the JAX CLI names process N's."""
    tag = "" if rank is None else f"[rank {rank}] "
    fmt = logging.Formatter(
        tag + "%(asctime)s [%(module)s::%(funcName)s] %(levelname)s: "
        "%(message)s", datefmt="%H:%M:%S")
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
