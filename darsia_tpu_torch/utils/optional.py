"""Imports of the optional libraries at call time: OpenCV, matplotlib,
tkinter, plotly, pydicom, meshio, pandas and its Excel readers.

The port imports none of them when it is imported: the card's machine has
OpenCV and pandas but no matplotlib, plotly, pydicom, meshio or openpyxl,
and a GUI-less host has no tkinter.  A function that decodes, encodes, draws, reads a
DICOM, VTU or Excel file or opens a window imports the library through
:func:`optional_module` when it runs, which raises an ``ImportError``
naming the library and what needed it.
"""

from __future__ import annotations

import importlib

__all__ = ["agg_pyplot", "optional_module"]

_LIBRARIES = {
    "cv2": "OpenCV (cv2)",
    "matplotlib": "matplotlib",
    "tkinter": "tkinter",
    "plotly": "plotly",
    "pydicom": "pydicom",
    "meshio": "meshio",
    "pandas": "pandas",
    "openpyxl": "openpyxl (pandas' .xlsx reader)",
    "xlrd": "xlrd (pandas' .xls reader)",
}


def optional_module(name: str, what: str):
    """The module ``name`` (``"cv2"``, ``"matplotlib.pyplot"``, ...), or an
    ``ImportError`` that names its library and ``what`` needed it."""
    try:
        return importlib.import_module(name)
    except ImportError as err:
        library = _LIBRARIES.get(name.split(".")[0], name)
        raise ImportError(f"{what} needs {library}, which does not import here") from err


def agg_pyplot(what: str):
    """``matplotlib.pyplot`` with the Agg backend selected first (files, no
    window), or an ``ImportError`` naming matplotlib and ``what``."""
    optional_module("matplotlib", what).use("Agg")
    return optional_module("matplotlib.pyplot", what)
