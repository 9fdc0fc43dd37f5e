"""CSV tables written cell for cell as pandas writes them, without pandas.

The JAX package keeps its workflow tables (the mass and volume analyses'
CSV, the comparison's distances) as pandas frames.  pandas is not part of the
port's environment, so the port writes the same files with the ``csv``
module: :func:`csv_cell` formats one cell as ``DataFrame.to_csv`` does, and
:class:`CsvTable` reads a file back with ``read_csv``'s type inference,
appends rows (columns joined in order of first appearance, as ``pd.concat``
joins them), sorts by a column (stable, missing values last, as
``sort_values`` does) and writes it with ``index=False``.  A float read back
is Python's ``float()`` of the cell, exact; pandas' C parser may move its
last bit, so after a second run the two packages' files can differ there.
An Excel sheet has no reader but pandas': :func:`read_excel_columns` imports
it (and its engine) when called.
"""

from __future__ import annotations

import csv
import math
import re
from datetime import datetime
from pathlib import Path
from typing import Optional

from .optional import optional_module

__all__ = ["CsvTable", "csv_cell", "datetime_column_cells", "read_excel_columns"]

_INT = re.compile(r"^[+-]?\d+$")
_BOOLS = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False, "false": False}


def _missing(value) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def csv_cell(value) -> str:
    """A cell as pandas' ``to_csv`` writes it: empty for None and NaN, the
    shortest repr for a float, ``str`` otherwise (a datetime as its
    ``Timestamp``: ``YYYY-MM-DD HH:MM:SS[.ffffff]``)."""
    if _missing(value):
        return ""
    if isinstance(value, float):
        return repr(value)
    if isinstance(value, datetime):
        return value.isoformat(sep=" ")
    return str(value)


def datetime_column_cells(values: list) -> list:
    """The cells of a column that holds only datetimes (or missing values),
    as pandas writes a ``datetime64`` column: dates alone where every value
    is a midnight, else seconds, with milli- or microseconds for the whole
    column where any value has them."""
    present = [v for v in values if not _missing(v)]
    if present and all(v.time() == datetime.min.time() for v in present):
        digits = None
    elif any(v.microsecond % 1000 for v in present):
        digits = 6
    elif any(v.microsecond for v in present):
        digits = 3
    else:
        digits = 0

    def cell(v) -> str:
        if _missing(v):
            return ""
        if digits is None:
            return v.strftime("%Y-%m-%d")
        text = v.strftime("%Y-%m-%d %H:%M:%S")
        return f"{text}.{v.microsecond:06d}"[: len(text) + 1 + digits] if digits else text

    return [cell(v) for v in values]


def read_excel_columns(path, sheet=None, what: str = "reading an Excel table") -> dict:
    """The columns of one sheet of an ``.xlsx`` or ``.xls`` file (the first
    sheet when ``sheet`` is None), read by ``pandas.read_excel``: column
    name -> cells in file order, a datetime as a ``datetime``, a missing
    cell as None.  Needs pandas and its reader for the suffix (openpyxl,
    xlrd)."""
    path = Path(path)
    pd = optional_module("pandas", what)
    optional_module("xlrd" if path.suffix.lower() == ".xls" else "openpyxl", what)
    frame = pd.read_excel(path, sheet_name=0 if sheet is None else sheet)

    def cell(value):
        if pd.isna(value):
            return None
        return value.to_pydatetime() if isinstance(value, pd.Timestamp) else value

    return {name: [cell(v) for v in frame[name].tolist()] for name in frame.columns}


def _infer_column(cells: list) -> list:
    """``read_csv``'s types for one column of cells: int, then float (an
    int column with a missing cell is float), then bool, else str; a missing
    cell is None."""
    present = [c for c in cells if c != ""]
    if present and all(_INT.match(c) for c in present):
        kind = int if len(present) == len(cells) else float
        return [kind(c) if c != "" else None for c in cells]
    try:
        return [float(c) if c != "" else None for c in cells] if present else [None] * len(cells)
    except ValueError:
        pass
    if all(c in _BOOLS for c in present):
        return [_BOOLS[c] if c != "" else None for c in cells]
    return [c if c != "" else None for c in cells]


class CsvTable:
    """Rows (dicts) under an ordered list of columns."""

    def __init__(self, columns: Optional[list] = None, rows: Optional[list] = None) -> None:
        self.columns = list(columns or [])
        self.rows = list(rows or [])

    @classmethod
    def read(cls, path) -> "CsvTable":
        """A table written by ``to_csv(index=False)``, typed as ``read_csv``
        types it."""
        with open(Path(path), newline="") as f:
            records = list(csv.reader(f))
        if not records:
            return cls()
        columns, body = records[0], records[1:]
        typed = {
            name: _infer_column([r[k] if k < len(r) else "" for r in body])
            for k, name in enumerate(columns)
        }
        rows = [{name: typed[name][i] for name in columns} for i in range(len(body))]
        return cls(columns, rows)

    @classmethod
    def read_or_empty(cls, path) -> "CsvTable":
        return cls.read(path) if Path(path).exists() else cls()

    def append(self, row: dict) -> None:
        """Append a row; its new columns join at the end."""
        self.columns += [c for c in row if c not in self.columns]
        self.rows.append(dict(row))

    def sort_by(self, column: str) -> None:
        """Stable sort by ``column``, missing values last."""

        def key(row):
            value = row.get(column)
            return (True, 0) if _missing(value) else (False, value)

        self.rows.sort(key=key)

    def _column_cells(self, column: str) -> list:
        values = [r.get(column) for r in self.rows]
        present = [v for v in values if not _missing(v)]
        if present and all(isinstance(v, datetime) for v in present):
            return datetime_column_cells(values)
        if present and all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in present):
            if any(isinstance(v, float) for v in values) or len(present) < len(values):
                # A numeric column with a float or a missing value is float64.
                return [csv_cell(None if _missing(v) else float(v)) for v in values]
        return [csv_cell(v) for v in values]

    def write(self, path) -> None:
        """Write as ``to_csv(path, index=False)`` does."""
        cells = [self._column_cells(c) for c in self.columns]
        with open(Path(path), "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(self.columns)
            for i in range(len(self.rows)):
                writer.writerow([column[i] for column in cells])

    def records(self) -> list:
        """The rows as dicts over every column (missing cells None), in the
        table's order: ``pandas.DataFrame(records)`` is the frame."""
        return [{c: r.get(c) for c in self.columns} for r in self.rows]
