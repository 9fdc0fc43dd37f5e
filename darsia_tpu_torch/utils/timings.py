"""Timing decorator (counterpart of :mod:`darsia_tpu.utils.timings`).

It logs host wall time; a call that launches work on a CUDA card returns
before that work ends unless it reads a result, so close such a call with
``torch.cuda.synchronize()`` to time the device's work too.
"""

from __future__ import annotations

import functools
import logging
import time

logger = logging.getLogger(__name__)

__all__ = ["timing_decorator"]


def timing_decorator(func):
    """Log the wall time of each call of ``func``."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        tic = time.time()
        result = func(*args, **kwargs)
        logger.info("%s executed in %.4f s.", func.__name__, time.time() - tic)
        return result

    return wrapper
