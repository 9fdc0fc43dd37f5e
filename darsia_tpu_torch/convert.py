"""Setup state carried over from the JAX package.

``FusedAnalysisPipeline`` in both packages keeps its setup products as a
nested dict of arrays: ``field_k`` (the fused correction field of stage k),
``reg`` (``base_spectra``, ``centers``, ``Ainv_x``/``Ainv_y``,
``E_x``/``E_y``), ``base`` (the corrected float baseline) and, in the
single-warp lane, ``coarse_pos`` (the coarse TPS grid's positions).  Given that
dict with numpy leaves (``np.asarray`` of the JAX arrays),
:func:`operands_from_numpy` builds the port's operands, which
``FusedAnalysisPipeline.__call__(image, operands=...)`` runs with.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["operands_from_numpy"]


def operands_from_numpy(state: dict, device) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.

    dtypes are kept (float32, complex64, int32).
    """
    out = {}
    for key, value in state.items():
        if isinstance(value, dict):
            out[key] = operands_from_numpy(value, device)
        else:
            out[key] = torch.from_numpy(np.array(value, copy=True)).to(device)
    return out
