"""ZTF BTS real-data ingest: files on disk -> fixed-shape ArrayDataset (port
of multimodal_supernovae_tpu/data/ztfbts.py, without pandas or PIL).

The on-disk layout is the reference's (SURVEY.md L0):

  <data_dir>/ZTFBTS_TransientTable.csv      per-SN metadata (ZTFID, redshift,
                                            type, A_V, ...)
  <data_dir>/light-curves/<ZTFID>.csv       columns time,mag,magerr,band
  <data_dir>/hostImgs/<ZTFID>.host.png      3-channel host cutout
  <spectra_dir>/<ZTFID>.csv                 headerless (wavelength, flux
                                            [, fluxerr]) rows

Ingest semantics follow src/dataloader.py (load_images :290, load_redshifts
:336, load_classes :368, load_lightcurves :444, load_spectras :578,
load_data :761): CCM89 extinction correction of magnitudes per band (A_V
from the transient table, R_V=3.1, the reference's effective wavelengths),
per-band pad/subsample + time zeroing + band-blocked concat, spectra
rescaling and zero-filled missing errors, and filename intersection across
modalities with redshift/class always appended.

Every CSV is read by the native reader (``data/native.py``, the JAX
package's native path), every PNG by ``data/png.py``. The transient table,
which the JAX package reads with pandas, is read with the native reader and
given pandas' meaning: pandas' default missing-value strings (the empty
cell, ``NA``, ``nan``, ``None``, ...) are missing, ``redshift`` is coerced
to numbers (``pd.to_numeric(errors="coerce")``), ``ZTFID`` and ``type``
are strings. One ``numpy`` generator threads through the light curves (band
R, then g, file by file) and then the spectra, so every subsampled row is
the JAX package's.
"""

from __future__ import annotations

import functools
import math
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import native
from .batching import ArrayDataset
from .extinction import ZTF_WAVE_EFF, ccm89
from .folds import stratified_kfolds
from .png import load_rgb
from .transforms import factorize_classes, process_ragged_series

BANDS = ("R", "g")  # ingest order defines the band-block layout

# pandas.read_csv's default missing-value strings (pandas._libs.parsers.STR_NA_VALUES)
PANDAS_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


def _pandas_str(col: np.ndarray) -> List[Optional[str]]:
    """A column as pandas would hold it, then ``astype(str)``: None where
    pandas reads a missing value. A numeric column is formatted as pandas
    formats its float64 (or int64, when every value is whole)."""
    if col.dtype != object:
        whole = bool(np.all(np.isfinite(col)) and np.all(col == np.round(col)))
        return [str(int(v)) if whole else (None if math.isnan(v) else str(v)) for v in col]
    return [None if s in PANDAS_NA else s for s in col]


def _pandas_float(col: np.ndarray) -> np.ndarray:
    """``pd.to_numeric(errors="coerce")`` of a column: missing values and
    cells that are no number become NaN."""
    if col.dtype != object:
        return col
    out = np.empty(len(col), dtype=np.float64)
    for i, s in enumerate(col):
        try:
            out[i] = math.nan if s in PANDAS_NA else float(s)
        except ValueError:
            out[i] = math.nan
    return out


@functools.lru_cache(maxsize=8)
def _cached_table(path: str, mtime: float) -> Dict[str, object]:
    cols = native.read_csv(path, header=True)
    ids = _pandas_str(cols["ZTFID"])
    table = {"ZTFID": ["nan" if s is None else s for s in ids],
             "redshift": _pandas_float(cols["redshift"])}
    if "type" in cols:
        table["type"] = _pandas_str(cols["type"])
    if "A_V" in cols:
        table["A_V"] = _pandas_float(cols["A_V"])
    return table


def load_transient_table(data_dir: str) -> Dict[str, object]:
    """The per-SN metadata table, parsed once per (path, mtime): ``ZTFID``
    (str), ``redshift`` and ``A_V`` (float64, NaN where missing or no
    number) and ``type`` (str, None where missing), in file order."""
    path = os.path.join(data_dir, "ZTFBTS_TransientTable.csv")
    return _cached_table(path, os.path.getmtime(path))


def load_images(
    data_dir: str, filenames: Optional[Sequence[str]] = None
) -> Tuple[np.ndarray, List[str]]:
    """hostImgs/*.host.png -> (N, H, W, 3) float32 in [0, 1] (NHWC)."""
    img_dir = os.path.join(data_dir, "hostImgs")
    avail = sorted(f for f in os.listdir(img_dir) if f.endswith(".host.png"))
    if filenames is not None:
        wanted = {f + ".host.png" for f in filenames}
        avail = [f for f in avail if f in wanted]
    imgs, names = [], []
    for fname in avail:
        img = load_rgb(os.path.join(img_dir, fname))
        imgs.append(np.asarray(img, dtype=np.float32) / 255.0)
        names.append(fname[: -len(".host.png")])
    return np.stack(imgs) if imgs else np.zeros((0, 0, 0, 3), np.float32), names


def load_lightcurves(
    data_dir: str,
    n_max_obs: int = 100,
    filenames: Optional[Sequence[str]] = None,
    rng: Optional[np.random.Generator] = None,
    abs_mag: bool = False,
) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Per-SN CSVs -> band-blocked (N, nband*n_max) arrays.

    Per band: CCM89-correct magnitudes (A_V from the table, R_V=3.1,
    reference wavelengths), pad/subsample to n_max_obs, shift valid times to
    start at 0, then concatenate bands along the sequence axis
    (dataloader.py:496-552).
    """
    rng = rng or np.random.default_rng(0)
    lc_dir = os.path.join(data_dir, "light-curves")
    table = load_transient_table(data_dir)
    known = set(table["ZTFID"])
    av_by_id = dict(zip(table["ZTFID"], table["A_V"]))

    avail = sorted(f for f in os.listdir(lc_dir) if f.endswith(".csv"))
    if filenames is not None:
        wanted = {f + ".csv" for f in filenames}
        avail = [f for f in avail if f in wanted]

    # Per-unit-A_V extinction for each band (polynomials evaluated once).
    ext_unit = {
        band: float(ccm89(np.array([ZTF_WAVE_EFF[band]]), 1.0, 3.1)[0])
        for band in BANDS
    }

    rows_t, rows_x, rows_e, rows_m, names = [], [], [], [], []
    for fname in avail:
        sn = Path(fname).stem
        if sn not in known:
            continue
        cols = native.read_csv(os.path.join(lc_dir, fname), header=True)
        if not all(c in cols for c in ("time", "mag", "magerr", "band")):
            continue
        band_col = np.asarray(cols["band"]).astype(str)
        av = float(av_by_id[sn])
        t_cat, x_cat, e_cat, m_cat = [], [], [], []
        for band in BANDS:
            sel = band_col == band
            mag = np.asarray(cols["mag"], dtype=np.float64)[sel]
            mag = mag - av * ext_unit[band]
            tt, xx, ee, mm = process_ragged_series(
                np.asarray(cols["time"], dtype=np.float64)[sel],
                mag,
                np.asarray(cols["magerr"], dtype=np.float64)[sel],
                n_max_obs,
                rng,
            )
            t_cat.append(tt)
            x_cat.append(xx)
            e_cat.append(ee)
            m_cat.append(mm)
        rows_t.append(np.concatenate(t_cat))
        rows_x.append(np.concatenate(x_cat))
        rows_e.append(np.concatenate(e_cat))
        rows_m.append(np.concatenate(m_cat))
        names.append(sn)

    arrays = {
        "t_lc": np.asarray(rows_t, dtype=np.float32),
        "x_lc": np.asarray(rows_x, dtype=np.float32),
        "err_lc": np.asarray(rows_e, dtype=np.float32),
        "mask_lc": np.asarray(rows_m, dtype=bool),
    }
    if abs_mag:
        # Apparent -> absolute magnitudes via the flat-LCDM distance modulus
        # (the reference's astropy Planck15 path, dataloader.py:559-575).
        # Redshifts come back in table order; re-align to our row order and
        # drop rows without a finite redshift.
        from .extinction import flat_lcdm_distmod

        z_vals, z_names = load_redshifts(data_dir, names)
        z_by_name = dict(zip(z_names, z_vals))
        z = np.array([z_by_name.get(n, np.nan) for n in names])
        ok = np.isfinite(z)
        mu = flat_lcdm_distmod(np.where(ok, z, 0.1))
        arrays["x_lc"] = arrays["x_lc"] - mu.astype(np.float32)[:, None]
        arrays = {k: v[ok] for k, v in arrays.items()}
        names = [n for n, good in zip(names, ok) if good]
    return arrays, names


def load_spectra(
    spectra_dir: str,
    n_max_obs: int = 1000,
    rescalefactor: float = 1e14,
    filenames: Optional[Sequence[str]] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Headerless (wavelength, flux[, err]) CSVs -> (N, n_max) arrays.

    Flux (and err) scaled by ``rescalefactor``; missing error columns become
    zeros; missing err values are zero-filled (dataloader.py:624-672).
    """
    rng = rng or np.random.default_rng(0)
    avail = sorted(
        f
        for f in os.listdir(spectra_dir)
        if f.endswith(".csv") and not f.startswith(".")
    )
    if filenames is not None:
        wanted = {f + ".csv" for f in filenames}
        avail = [f for f in avail if f in wanted]

    rows_t, rows_x, rows_e, rows_m, names = [], [], [], [], []
    for fname in avail:
        cols = native.read_csv(os.path.join(spectra_dir, fname), header=False)
        vals = list(cols.values())
        freq = np.asarray(vals[0], dtype=np.float64)
        spec = np.asarray(vals[1], dtype=np.float64) * rescalefactor
        if len(vals) >= 3:
            err = np.nan_to_num(np.asarray(vals[2], dtype=np.float64)) * rescalefactor
        else:
            err = np.zeros_like(spec)
        tt, xx, ee, mm = process_ragged_series(
            freq, spec, err, n_max_obs, rng, zero_time=False
        )
        rows_t.append(tt)
        rows_x.append(xx)
        rows_e.append(ee)
        rows_m.append(mm)
        names.append(Path(fname).stem)

    arrays = {
        "t_sp": np.asarray(rows_t, dtype=np.float32),
        "x_sp": np.asarray(rows_x, dtype=np.float32),
        "err_sp": np.asarray(rows_e, dtype=np.float32),
        "mask_sp": np.asarray(rows_m, dtype=bool),
    }
    return arrays, names


def _table_rows(data_dir: str, column: str, filenames: Sequence[str]):
    """Indices, in table order, of the rows whose ``column`` is present and
    whose ZTFID is among ``filenames`` (pandas' ``dropna`` then ``isin``)."""
    table = load_transient_table(data_dir)
    values, wanted = table[column], set(filenames)
    present = (~np.isnan(values) if column == "redshift"
               else np.array([v is not None for v in values], dtype=bool))
    return table, [i for i, (n, ok) in enumerate(zip(table["ZTFID"], present))
                   if ok and n in wanted]


def load_redshifts(data_dir: str, filenames: Sequence[str]) -> Tuple[np.ndarray, List[str]]:
    """Redshifts for the given IDs, in table order, NaNs dropped
    (dataloader.py:336-365)."""
    table, rows = _table_rows(data_dir, "redshift", filenames)
    return (np.asarray(table["redshift"][rows], dtype=np.float32),
            [table["ZTFID"][i] for i in rows])


def load_classes(
    data_dir: str, n_classes: int, filenames: Sequence[str]
) -> Tuple[np.ndarray, List[str]]:
    """Factorized SN-type labels for the given IDs (dataloader.py:368-416)."""
    table, rows = _table_rows(data_dir, "type", filenames)
    labels, keep, _ = factorize_classes([table["type"][i] for i in rows], n_classes)
    names = [table["ZTFID"][i] for i, k in zip(rows, keep) if k]
    return labels, names


def load_ztfbts(
    data_dir: str,
    spectra_dir: Optional[str] = None,
    combinations: Sequence[str] = ("host_galaxy", "lightcurve"),
    max_data_len_lc: int = 100,
    max_data_len_spec: int = 1000,
    n_classes: int = 5,
    spectral_rescalefactor: float = 1e14,
    filenames: Optional[Sequence[str]] = None,
    kfolds: Optional[int] = 5,
    seed: int = 0,
    abs_mag: bool = False,
):
    """The unified loader (reference ``load_data``, dataloader.py:761-905).

    Returns (ArrayDataset, nband, folds). Filenames are intersected across
    all requested modalities plus redshift and class availability; rows are
    ordered by sorted ZTFID (every per-modality loader walks sorted listings,
    so intersection preserves a common order).
    """
    spectra_dir = spectra_dir or data_dir
    rng = np.random.default_rng(seed)
    combos = set(combinations)
    nband = len(BANDS) if "lightcurve" in combos else 1

    arrays: Dict[str, np.ndarray] = {}
    names: Optional[List[str]] = list(filenames) if filenames is not None else None

    def intersect(new_names: Sequence[str]):
        nonlocal names, arrays
        if names is None:
            names = list(new_names)
            return
        keep_set = set(new_names)
        keep = np.array([n in keep_set for n in names], dtype=bool)
        names = [n for n, k in zip(names, keep) if k]
        arrays = {k: v[keep] for k, v in arrays.items()}

    if "host_galaxy" in combos:
        imgs, img_names = load_images(data_dir, names)
        intersect(img_names)
        idx = {n: i for i, n in enumerate(img_names)}
        arrays["x_img"] = imgs[np.array([idx[n] for n in names])]

    if "lightcurve" in combos:
        lc_arrays, lc_names = load_lightcurves(
            data_dir, max_data_len_lc, names, rng, abs_mag=abs_mag
        )
        intersect(lc_names)
        # re-align the lc arrays to the (possibly smaller) intersection
        idx = {n: i for i, n in enumerate(lc_names)}
        sel = np.array([idx[n] for n in names])
        arrays.update({k: v[sel] for k, v in lc_arrays.items()})

    if "spectral" in combos:
        sp_arrays, sp_names = load_spectra(
            spectra_dir, max_data_len_spec, spectral_rescalefactor, names, rng
        )
        intersect(sp_names)
        idx = {n: i for i, n in enumerate(sp_names)}
        sel = np.array([idx[n] for n in names])
        arrays.update({k: v[sel] for k, v in sp_arrays.items()})

    # redshift + class always ride along (dataloader.py:871-891)
    z, z_names = load_redshifts(data_dir, names)
    intersect(z_names)
    idx = {n: i for i, n in enumerate(z_names)}
    arrays["redshift"] = z[np.array([idx[n] for n in names])]

    labels, c_names = load_classes(data_dir, n_classes, names)
    intersect(c_names)
    idx = {n: i for i, n in enumerate(c_names)}
    arrays["label"] = labels[np.array([idx[n] for n in names])]

    folds = stratified_kfolds(arrays["label"], kfolds) if kfolds else None
    return ArrayDataset(arrays, names), nband, folds
