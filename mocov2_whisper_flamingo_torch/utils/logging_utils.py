"""Debug logging helpers (capability parity with reference:
utils/logging_utils.py:5-25 — opt-in tensor shape/range dumps threaded through
models via ``enable_logging``)."""

from __future__ import annotations

import logging

import numpy as np


def setup_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(
        level=level,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )


def log_tensor_info(logger: logging.Logger, name: str, tensor) -> None:
    """Shape/dtype/range dump of a tensor or array (read back to the host)."""
    if hasattr(tensor, "detach"):
        tensor = tensor.detach().float().cpu().numpy()
    arr = np.asarray(tensor)
    logger.info("%s: shape=%s dtype=%s min=%.4g max=%.4g",
                name, arr.shape, arr.dtype, arr.min(), arr.max())
