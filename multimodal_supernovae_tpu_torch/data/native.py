"""The native host library of the data layer: ``csrc/fastcsv.cpp`` bound with
ctypes (port of multimodal_supernovae_tpu/data/native/, same C ABI).

``read_csv`` parses a CSV in C++ (one read, tokenised in place, each column
typed numeric or string as a whole) in place of pandas; ``png_unfilter``
reverses the PNG row filters for ``data/png.py``. The library is built at
first use by ``kernels.build`` with the host compiler into the git-ignored
``.kernel_build/``; a failed build raises, and nothing falls back to a
Python reader.

``read_csv_plain`` is the plain version of ``read_csv``, the same
semantics in Python (``csv``-free splitting and numpy), which the tests
and ``chip_smoke.py`` hold the library to; nothing on the ingest path calls
it.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, List

import numpy as np

_LIB = "fastcsv"
_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is None:
            from ..kernels.build import load_library

            lib = load_library(_LIB)
            lib.fastcsv_parse.restype = ctypes.c_void_p
            lib.fastcsv_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.fastcsv_ncols.restype = ctypes.c_int
            lib.fastcsv_ncols.argtypes = [ctypes.c_void_p]
            lib.fastcsv_nrows.restype = ctypes.c_longlong
            lib.fastcsv_nrows.argtypes = [ctypes.c_void_p]
            lib.fastcsv_colname.restype = ctypes.c_char_p
            lib.fastcsv_colname.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.fastcsv_col_is_numeric.restype = ctypes.c_int
            lib.fastcsv_col_is_numeric.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.fastcsv_copy_numeric.restype = None
            lib.fastcsv_copy_numeric.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
            lib.fastcsv_string_item.restype = ctypes.c_char_p
            lib.fastcsv_string_item.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
            lib.fastcsv_free.restype = None
            lib.fastcsv_free.argtypes = [ctypes.c_void_p]
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]
            _lib = lib
        return _lib


def ensure_built() -> None:
    """Build (if needed) and load the library; raises when it cannot."""
    _load()


def read_csv(path: str, header: bool = True) -> Dict[str, np.ndarray]:
    """Parse a CSV into {column name (or its index as a string): array}.

    Numeric columns come back float64 (empty cells NaN); the others as
    object arrays of str."""
    lib = _load()
    handle = lib.fastcsv_parse(path.encode(), 1 if header else 0)
    if not handle:
        raise IOError(f"fastcsv failed to parse {path}")
    try:
        ncols = lib.fastcsv_ncols(handle)
        nrows = lib.fastcsv_nrows(handle)
        out: Dict[str, np.ndarray] = {}
        for c in range(ncols):
            name = lib.fastcsv_colname(handle, c).decode() if header else str(c)
            if lib.fastcsv_col_is_numeric(handle, c):
                buf = np.empty(nrows, dtype=np.float64)
                lib.fastcsv_copy_numeric(
                    handle, c, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
                out[name] = buf
            else:
                out[name] = np.array(
                    [lib.fastcsv_string_item(handle, c, r).decode() for r in range(nrows)],
                    dtype=object)
        return out
    finally:
        lib.fastcsv_free(handle)


_NAN_SPELLINGS = ("nan", "NaN", "NA")
# what a column of plain decimal numbers is written with (the fast path below)
_DECIMAL_CHARS = str.maketrans("", "", "0123456789.eE+-\n,")


def _cell_value(cell: str):
    """fastcsv's ``parse_double`` of one trimmed cell: NaN for an empty cell
    or a NaN spelling, the number when the whole cell is one (``strtod``:
    no digit separators, no trailing white space, no overflow; hexadecimal
    floats are not read as numbers here), else None."""
    if cell == "":
        return math.nan
    if len(cell) < 64 and "_" not in cell and not cell[-1].isspace():
        try:
            v = float(cell)
        except ValueError:
            v = None
        if v is not None and (not math.isinf(v) or "inf" in cell.lower()):
            return v
    return math.nan if cell in _NAN_SPELLINGS else None


def _decimals(cells: List[str]):
    """float64 of cells that are all plain decimal numbers or empty (where
    strtod and ``float`` agree), else None."""
    if not cells or max(map(len, cells)) >= 64 or "\n".join(cells).translate(_DECIMAL_CHARS):
        return None
    try:
        out = np.array(["nan" if c == "" else c for c in cells], dtype=np.float64)
    except ValueError:
        return None
    return None if np.isinf(out).any() else out


def _column(cells: List[str]) -> np.ndarray:
    """One column: float64 when every cell is a number or empty, else str."""
    out = _decimals(cells)
    if out is not None:
        return out
    values = [_cell_value(c) for c in cells]
    if all(v is not None for v in values):
        return np.array(values, dtype=np.float64).reshape(len(cells))
    return np.array(cells, dtype=object).reshape(len(cells))


def read_csv_plain(path: str, header: bool = True) -> Dict[str, np.ndarray]:
    """``read_csv`` in Python: lines split at ``\\n`` (blank ones skipped),
    fields at ``,``, each trimmed of trailing ``\\r`` and spaces and leading
    spaces; the first line fixes the columns (short rows read empty cells,
    extra fields are dropped); a column is numeric when every cell is."""
    with open(path, "rb") as f:
        text = f.read().decode()
    lines = [line for line in text.split("\n") if line]
    if not lines:
        return {}
    ncols = lines[0].count(",") + 1
    if " " not in text and "\r" not in text and all(
            line.count(",") == ncols - 1 for line in lines):
        flat = ",".join(lines).split(",")  # nothing to trim, every row full
        body = _decimals(flat[ncols:] if header else flat)
        if body is not None:  # every column numeric, parsed at once
            names = flat[:ncols] if header else [str(c) for c in range(ncols)]
            body = body.reshape(-1, ncols)
            return {name: body[:, c].copy() for c, name in enumerate(names)}
        columns = [flat[c::ncols] for c in range(ncols)]
    else:
        rows = [[fld.rstrip("\r ").lstrip(" ") for fld in line.split(",")]
                for line in lines]
        columns = [[r[c] if c < len(r) else "" for r in rows] for c in range(ncols)]
    names = [col[0] for col in columns] if header else [str(c) for c in range(ncols)]
    return {name: _column(col[1:] if header else col) for name, col in zip(names, columns)}


def png_unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Reverse the PNG row filters (8-bit samples): ``raw`` is the inflated
    image data, ``height`` rows of a filter-type byte and ``row_bytes``
    bytes; returns (height, row_bytes) uint8."""
    lib = _load()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, want {height * (row_bytes + 1)}")
    out = np.empty((height, row_bytes), dtype=np.uint8)
    rc = lib.png_unfilter(raw.ctypes.data, out.ctypes.data, height, row_bytes, bpp)
    if rc != 0:
        row = -1 - rc
        raise ValueError(f"unknown PNG filter type {raw[row * (row_bytes + 1)]} in row {row}")
    return out
