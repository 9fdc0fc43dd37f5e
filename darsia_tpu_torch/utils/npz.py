"""Reading npz files that either package wrote, without the JAX package.

``Image.save`` and some ``save`` methods of the JAX package store object
arrays (metadata and config dictionaries).  ``numpy.load`` unpickles them
with the stock unpickler, which imports whatever module a pickled class
names: an ``origin`` of type ``darsia_tpu.utils.point.Coordinate`` would
import the JAX package, which a machine with only this package lacks.
:func:`load_npz` reads the zip members itself and unpickles object arrays
with an unpickler that maps the JAX package's point types to this package's
and refuses every other name of the JAX package.

As with ``numpy.load(allow_pickle=True)``, read only files that you or your
rig wrote: unpickling runs code.
"""

from __future__ import annotations

import pickle
import zipfile
from pathlib import Path
from typing import Optional, Union

import numpy as np
from numpy.lib import format as npy_format

__all__ = ["load_npz"]

_POINT_MODULE = "darsia_tpu.utils.point"


class _PortUnpickler(pickle.Unpickler):
    """Point types of the JAX package resolve to this package's."""

    def find_class(self, module: str, name: str):
        if module == _POINT_MODULE:
            from . import point

            if name in point.__all__:
                return getattr(point, name)
        if module == "darsia_tpu" or module.startswith("darsia_tpu."):
            raise pickle.UnpicklingError(
                f"the file pickles {module}.{name}, which only the JAX package has"
            )
        return super().find_class(module, name)


def _read_member(fp) -> np.ndarray:
    version = npy_format.read_magic(fp)
    if version == (1, 0):
        shape, fortran_order, dtype = npy_format.read_array_header_1_0(fp)
    else:
        shape, fortran_order, dtype = npy_format.read_array_header_2_0(fp)
    if not dtype.hasobject:
        count = int(np.prod(shape, dtype=np.int64))
        array = np.frombuffer(fp.read(count * dtype.itemsize), dtype=dtype, count=count)
        return array.reshape(shape, order="F" if fortran_order else "C").copy()
    array = np.asarray(_PortUnpickler(fp).load(), dtype=object)
    return array.reshape(shape)


def load_npz(path: Union[str, Path], names: Optional[tuple] = None) -> dict:
    """The arrays of an npz file (plain or compressed) by name: all of them,
    or only ``names`` (those of them the file has)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"File {path} not found.")
    arrays = {}
    with zipfile.ZipFile(path) as archive:
        for member in archive.namelist():
            name = member.removesuffix(".npy")
            if names is not None and name not in names:
                continue
            with archive.open(member) as fp:
                arrays[name] = _read_member(fp)
    return arrays
