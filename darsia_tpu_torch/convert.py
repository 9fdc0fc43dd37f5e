"""Setup state carried over from the JAX package.

``FusedAnalysisPipeline`` in both packages keeps its setup products as a
nested dict of arrays: ``field_k`` (the fused correction field of stage k),
``reg`` (``base_spectra``, ``centers``, ``Ainv_x``/``Ainv_y``,
``E_x``/``E_y``), ``base`` (the corrected float baseline) and, in the
single-warp lane, ``coarse_pos`` (the coarse TPS grid's positions).  Given that
dict with numpy leaves (``np.asarray`` of the JAX arrays),
:func:`operands_from_numpy` builds the port's operands, which
``FusedAnalysisPipeline.__call__(image, operands=...)`` runs with.

The heterogeneous colour-to-mass chain's calibration (a folder the JAX
package's ``HeterogeneousColorToMassAnalysis.save`` writes) is, in plain
Python and numpy, one dict per label of the colour path and its values, one
of the signal function, and the flash's four bounds; from that
:func:`chain_parts_from_calibration` builds the port's chain parts.
``HeterogeneousColorToMassAnalysis.from_folder`` and ``load`` read a folder
through it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["chain_parts_from_calibration", "operands_from_numpy"]


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


def chain_parts_from_calibration(calibration: dict) -> tuple:
    """The port's parts of a heterogeneous colour-to-mass chain.

    Args:
        calibration: ``{"color_paths": {label: {"colors", "base_color",
            "mode", "values"[, "name", "color_mode", "ignore_spectrum"]}},
            "signal_functions": {label: {"supports", "values"}}, "flash":
            [min_value_aq, max_value_aq, min_value_g, max_value_g] or None}``
            with lists or numpy arrays as values; ``color_mode`` defaults to
            "relative", an ``ignore_spectrum`` dict is kept as it is.

    Returns:
        (``{label: ColorPathInterpolation}``, ``{label: PWTransformation}``,
        ``SimpleFlash`` or None), labels as ints.

    """
    from .multiphase.flash import SimpleFlash
    from .signals.color.color_mode import ColorMode
    from .signals.color.color_path import ColorPath
    from .signals.models.color_path_interpolation import ColorPathInterpolation
    from .signals.models.pwtransformation import PWTransformation

    interpretations = {}
    for label, entry in calibration.get("color_paths", {}).items():
        path = ColorPath(
            colors=[np.asarray(c, dtype=float) for c in entry["colors"]],
            base_color=np.asarray(entry["base_color"], dtype=float),
            mode=entry.get("mode", "rgb"),
            name=entry.get("name", "ColorPath"),
        )
        interpretations[int(label)] = ColorPathInterpolation(
            path,
            ColorMode(entry.get("color_mode", "relative")),
            values=np.asarray(entry["values"], dtype=float),
            ignore_spectrum=entry.get("ignore_spectrum") or None,
        )
    signal_functions = {
        int(label): PWTransformation(
            supports=np.asarray(entry["supports"], dtype=float),
            values=np.asarray(entry["values"], dtype=float),
        )
        for label, entry in calibration.get("signal_functions", {}).items()
    }
    bounds = calibration.get("flash")
    flash = None if bounds is None else SimpleFlash(*[float(v) for v in bounds])
    return interpretations, signal_functions, flash
