"""Imports of the optional libraries (OpenCV, matplotlib, tkinter) at call
time.

The port imports none of them when it is imported: the card's machine has
OpenCV but no matplotlib, and a GUI-less host has no tkinter.  A function
that decodes, encodes, draws or opens a window imports the library through
:func:`optional_module` when it runs, which raises an ``ImportError``
naming the library and what needed it.
"""

from __future__ import annotations

import importlib

__all__ = ["optional_module"]

_LIBRARIES = {"cv2": "OpenCV (cv2)", "matplotlib": "matplotlib", "tkinter": "tkinter"}


def optional_module(name: str, what: str):
    """The module ``name`` (``"cv2"``, ``"matplotlib.pyplot"``, ...), or an
    ``ImportError`` that names its library and ``what`` needed it."""
    try:
        return importlib.import_module(name)
    except ImportError as err:
        library = _LIBRARIES.get(name.split(".")[0], name)
        raise ImportError(f"{what} needs {library}, which does not import here") from err
