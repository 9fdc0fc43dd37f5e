"""Imports of the optional libraries (OpenCV, matplotlib) at call time.

The port imports neither when it is imported: the card's machine has no
matplotlib.  A function that draws or traces contours imports the library
through :func:`optional_module` when it runs, which raises an
``ImportError`` naming the library and what needed it.
"""

from __future__ import annotations

import importlib

__all__ = ["optional_module"]

_LIBRARIES = {"cv2": "OpenCV (cv2)", "matplotlib": "matplotlib"}


def optional_module(name: str, what: str):
    """The module ``name`` (``"cv2"``, ``"matplotlib.pyplot"``, ...), or an
    ``ImportError`` that names its library and ``what`` needed it."""
    try:
        return importlib.import_module(name)
    except ImportError as err:
        library = _LIBRARIES.get(name.split(".")[0], name)
        raise ImportError(f"{what} needs {library}, which does not import here") from err
