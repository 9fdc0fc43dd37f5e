"""Scalar mass products and the rescaling to the injected mass.

Counterpart of :mod:`darsia_tpu.presets.workflows.analysis.scalar_products`:
the workflow steps ask for quantities by mode string; this module renders
the product dict from a colour-to-mass result, optionally rescaled onto the
injection protocol's injected mass and constrained by the expert knowledge.
The products are images on the result's device; only the two totals of the
rescaling are read on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ....image.arithmetics import weight
from ..mode_resolution import _MASS_FIELDS, _RESCALABLE, SCALAR_PRODUCT_MODES

#: Detected-mass magnitudes below this are treated as zero (no rescaling).
EPSILON = 1e-12

__all__ = [
    "RescaledMassProducts",
    "compute_rescaled_mass_products",
    "analysis_scalar_products",
    "requires_rescaled_modes",
]

#: Quantities the expert-knowledge adapter knows how to constrain, and the
#: adapter mode each maps to (rescaled variants share the base mode).
_CONSTRAINABLE = ("concentration_aq", "saturation_g")


def requires_rescaled_modes(modes) -> bool:
    """True when any requested mode needs the injected-mass rescaling pass."""
    return not SCALAR_PRODUCT_MODES.isdisjoint(modes or ())


def _constrain(products: dict, adapter) -> dict:
    """Run the expert-knowledge adapter over every constrainable product."""
    if adapter is None:
        return products
    out = dict(products)
    for base in _CONSTRAINABLE:
        for key in (base, f"rescaled_{base}"):
            img = out.get(key)
            if img is not None:
                out[key] = adapter.apply(img, base)
    return out


@dataclass
class RescaledMassProducts:
    """Rescaled mass-analysis result plus the scaling diagnostics."""

    rescaled_result: Any
    mass_scaling_factor: float
    detected_mass_total: float
    exact_mass_total: float


def compute_rescaled_mass_products(
    *,
    mass_analysis_result,
    geometry,
    injection_protocol,
    co2_mass_analysis,
    date=None,
    epsilon: float = EPSILON,
) -> RescaledMassProducts:
    """Rescale detected total mass onto the protocol's injected mass.

    The scaling factor is exact/detected; the rescaled mass field is pushed
    back through the inverse mass analysis so ALL derived quantities
    (saturation, aqueous concentration) stay thermodynamically consistent
    rather than being scaled independently.
    """
    detected = float(geometry.integrate(mass_analysis_result.mass))
    exact = float(injection_protocol.injected_mass(date=date))
    factor = exact / detected if abs(detected) > epsilon else 1.0
    rescaled_result = co2_mass_analysis.inverse_mass_analysis(
        weight(mass_analysis_result.mass, factor)
    )
    return RescaledMassProducts(
        rescaled_result=rescaled_result,
        mass_scaling_factor=factor,
        detected_mass_total=detected,
        exact_mass_total=exact,
    )


def analysis_scalar_products(
    *,
    mass_analysis_result,
    requested_modes=None,
    geometry=None,
    injection_protocol=None,
    co2_mass_analysis=None,
    date=None,
    expert_knowledge_adapter=None,
):
    """Render every base product, plus rescaled products when requested.

    Returns ``(products, rescaled_info)`` where ``products`` maps each mode
    string in ``mode_resolution._MASS_FIELDS`` (and, when requested, the
    ``rescaled_*`` modes) to its scalar image, and ``rescaled_info`` is the
    :class:`RescaledMassProducts` diagnostics or None.
    """
    products = {
        mode: getattr(mass_analysis_result, field)
        for mode, field in _MASS_FIELDS.items()
    }
    products = _constrain(products, expert_knowledge_adapter)

    if not requires_rescaled_modes(requested_modes):
        return products, None

    missing = [
        name
        for name, obj in (
            ("geometry", geometry),
            ("injection_protocol", injection_protocol),
            ("co2_mass_analysis", co2_mass_analysis),
        )
        if obj is None
    ]
    if missing:
        raise ValueError(
            "Rescaled modes requested but missing " + "/".join(missing) + "."
        )

    rescaled = compute_rescaled_mass_products(
        mass_analysis_result=mass_analysis_result,
        geometry=geometry,
        injection_protocol=injection_protocol,
        co2_mass_analysis=co2_mass_analysis,
        date=date,
    )
    for q in _RESCALABLE:
        field = _MASS_FIELDS[q]
        products[f"rescaled_{q}"] = getattr(rescaled.rescaled_result, field)
    return _constrain(products, expert_knowledge_adapter), rescaled
