"""Analysis-mode strings -> scalar images, table-driven.

Workflow configs select what quantity a step operates on via a short mode
string.  Three families exist (behavioral parity with the reference's
``presets/workflows/mode_resolution.py:14-170``; the mode vocabulary is
fixed by TOML-config compatibility):

====================  =====================================================
family                resolution
====================  =====================================================
mass/legacy           attribute lookup on a color-to-mass analysis result
                      (``_MASS_FIELDS`` below)
rescaled              precomputed scalar products, keyed ``rescaled_<q>``
color embedding       ``[color.*.*]`` registry entry rendered through the
                      embedding runtime
====================  =====================================================
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

__all__ = [
    "LEGACY_COLOR_TO_MASS_MODES",
    "SCALAR_PRODUCT_MODES",
    "ColorEmbeddingMode",
    "parse_color_mode",
    "validate_mode_syntax",
    "mode_requires_color_to_mass",
    "resolve_mode_image",
]

# Single source of truth: mode string -> attribute of the color-to-mass
# result object.  The public mode sets are derived views of this table.
_MASS_FIELDS = {
    "mass": "mass",
    "mass_total": "mass",  # alias
    "mass_g": "mass_g",
    "mass_aq": "mass_aq",
    "concentration_aq": "concentration_aq",
    "saturation_g": "saturation_g",
}

_RESCALABLE = ("mass", "saturation_g", "concentration_aq")

LEGACY_COLOR_TO_MASS_MODES = frozenset(_MASS_FIELDS)
SCALAR_PRODUCT_MODES = frozenset(f"rescaled_{q}" for q in _RESCALABLE)


@dataclass(frozen=True)
class ColorEmbeddingMode:
    """A ``color.<id>`` mode reference, pointing into the embedding registry."""

    name: str


def parse_color_mode(mode: str) -> Optional[ColorEmbeddingMode]:
    """Split ``"color.<id>"`` into its embedding id; None for other modes."""
    prefix, dot, ident = mode.partition(".")
    if dot and prefix.lower() == "color" and "." not in ident:
        return ColorEmbeddingMode(name=ident.strip())
    return None


def _known_embedding(mode: str, registry) -> bool:
    return registry is not None and mode in registry.embeddings


def validate_mode_syntax(
    mode: str, color_embedding_registry=None, key: str = "mode"
) -> None:
    """Raise ValueError unless ``mode`` belongs to a known family."""
    mode = mode.strip()
    known = (
        mode in LEGACY_COLOR_TO_MASS_MODES
        or mode in SCALAR_PRODUCT_MODES
        or _known_embedding(mode, color_embedding_registry)
    )
    if not known:
        raise ValueError(
            f"Unsupported {key} {mode!r}. Supported: legacy mass modes, "
            "rescaled modes, and color embedding ids from [color.*.*]."
        )


def mode_requires_color_to_mass(mode: str) -> bool:
    """True when resolving ``mode`` needs a color-to-mass analysis result."""
    mode = mode.strip()
    return mode in LEGACY_COLOR_TO_MASS_MODES or mode in SCALAR_PRODUCT_MODES


def resolve_mode_image(
    mode: str,
    image,
    mass_analysis_result: Any = None,
    color_embedding_registry=None,
    color_embedding_runtime=None,
    scalar_products: Optional[dict] = None,
):
    """Render the scalar image a mode string denotes.

    Precedence: precomputed scalar product (rescaled family) -> mass-result
    attribute (legacy family) -> color embedding.  ``image`` is only read by
    the embedding family; the other two return previously computed fields.
    """
    mode = mode.strip()

    precomputed = (scalar_products or {}).get(mode)
    if precomputed is not None:
        return precomputed

    field = _MASS_FIELDS.get(mode)
    if field is not None:
        if mass_analysis_result is None:
            raise ValueError(f"Mode {mode!r} requires color-to-mass results.")
        return getattr(mass_analysis_result, field)

    if _known_embedding(mode, color_embedding_registry):
        if color_embedding_runtime is None:
            raise ValueError(
                "Color mode resolution requires a runtime with rig/baseline."
            )
        embedding = color_embedding_registry.resolve(mode)
        return embedding.to_scalar_image(image, color_embedding_runtime)

    raise ValueError(f"Unsupported analysis mode {mode!r}.")
