"""Structured logging (the reference has printf-only observability,
SURVEY §5)."""

from __future__ import annotations

import logging
import os
import sys

_FMT = "%(asctime)s %(levelname).1s matrix_fhe %(name)s] %(message)s"


def get_logger(name: str = "core") -> logging.Logger:
    logger = logging.getLogger(f"matrix_fhe.{name}")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("MATRIX_FHE_LOG", "INFO"))
        logger.propagate = False
    return logger
