"""Mixed-dimensional data: 1-D data embedded in 2-D and superposed.

The port of the JAX package's ``examples/vtu_images.py`` (synthetic branch;
no VTU files are in the repository): a smooth 2-D concentration and a
narrow fracture strip on the same domain, superposed weighted by porosity,
then integrated.  ``imread`` of ``.vtu`` files reads such fields where
meshio imports.
"""

from __future__ import annotations

import numpy as np

from .. import Geometry, ScalarImage, superpose, weight
from ..image.image import card_unless
from . import Report, cli


def main(device=None, fast: bool = False) -> dict:
    device = card_unless(device, "the VTU images example")
    report = Report()
    yy, xx = np.meshgrid(np.linspace(0, 1, 200), np.linspace(0, 1, 200), indexing="ij")
    matrix_c = np.exp(-10 * ((xx - 0.4) ** 2 + (yy - 0.5) ** 2))
    image_2d = ScalarImage(matrix_c, width=1.0, height=1.0, device=device)
    fracture_c = np.zeros_like(matrix_c)
    fracture_c[:, 98:102] = 1.0
    image_1d = ScalarImage(fracture_c, width=1.0, height=1.0, device=device)

    # Equi-dimensional reconstruction: porosity-weighted superposition.
    porosity_2d, porosity_1d = 0.211, 1.0
    image = superpose([weight(image_2d, porosity_2d), weight(image_1d, porosity_1d)])
    report("superposed shape:", image.shape)

    # Integrate the combined concentration over the domain (on the device).
    mass = float(Geometry(**image.shape_metadata()).integrate(image))
    report("integrated mass:", mass)
    if not np.isfinite(mass):
        raise RuntimeError(f"integrated mass {mass}")
    return {"lines": report.lines, "mass": mass}


if __name__ == "__main__":
    cli(main)
