"""Simulated-transient (HDF5) ingest for Maven pretraining (port of
multimodal_supernovae_tpu/data/simulation.py, on the port's own HDF5 reader,
``data/hdf5.py``, in place of h5py).

HDF5 schemas handled (the reference's two dataset classes):

  * ``Photometry/<type>/<model>``: TID, z, mjd, filter (1=ZTF-g, 2=ZTF-R),
    mag_obs / mag_perfect; ``Spectroscopy/<type>/<model>``: TID, wavelength,
    flux_obs / flux_perfect: the multimodal pretraining corpus
    (``SimulationDataset``, src/dataloader.py:1037-1229).
  * ``TransientTable/<type>/<model>``: MJD, mag_<band>, mwebv with mag>=98
    as the not-observed sentinel and the (mag - 23.74)/1.6 normalisation:
    the legacy light-curve-only corpus (``SimulationLightcurveDataset``,
    src/dataloader.py:908-1034).

Each model group's (N, L) matrices are processed in one vectorised pass
(``transforms.pack_ragged_rows``), groups in h5py's order (by name), and
the result is a fixed-shape ArrayDataset that caches to disk
(``data/cache.py``) and uploads to the card once. The random draws are the
JAX package's, in its order, so both packages ingest a file bitwise alike.
TID alignment between photometry and spectroscopy is checked group-wise,
like the reference's per-item assert (dataloader.py:1191-1193).

``stream_simulation_to_cache`` writes the same rows into a sharded cache
(``data/streaming.py``) group by group instead, for a corpus larger than
host or device memory, which ``Trainer.fit_sharded`` trains over.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import hdf5
from .batching import ArrayDataset
from .extinction import CCM89_UNIT_AV_RV31
from .transforms import pack_ragged_rows, zero_time_origin_rows

BAND_CODES = {"g": 1, "R": 2}  # 'filter' integers (dataloader.py:1150-1153)


def _as_matrix(dset):
    """HDF5 dataset -> (dense (N, L) float64 matrix, presence mask); vlen
    rows are zero-padded to the longest."""
    arr = dset[...]
    if arr.dtype == object:  # variable-length rows
        lengths = [len(a) for a in arr]
        out = np.zeros((len(arr), max(lengths) if lengths else 0), np.float64)
        pad_mask = np.zeros(out.shape, bool)
        for i, a in enumerate(arr):
            out[i, : len(a)] = a
            pad_mask[i, : len(a)] = True
        return out, pad_mask
    m = np.asarray(arr, dtype=np.float64)
    return m, np.ones(m.shape, bool)


def _iter_groups(file, top: str, transient_types: Optional[Sequence[str]]):
    types = list(transient_types) if transient_types else list(file[top].keys())
    for t_type in types:
        for model in file[top][t_type].keys():
            yield t_type, model


def iter_simulation_chunks(
    hdf5_path: str,
    bands: Sequence[str] = ("r",),
    n_max_obs: int = 100,
    n_max_obs_spec: int = 220,
    combinations: Sequence[str] = ("lightcurve",),
    noise: bool = True,
    dataset_length: Optional[int] = None,
    transient_types: Optional[Sequence[str]] = None,
    seed: int = 0,
):
    """Yield canonical-field chunks, one HDF5 model group at a time, each
    fully preprocessed (packed, masked, time-zeroed); only one group's
    matrices are in host memory at once."""
    rng = np.random.default_rng(seed)
    combos = set(combinations)
    want_lc = "lightcurve" in combos
    want_sp = "spectral" in combos

    total = 0
    with hdf5.File(hdf5_path) as f:
        top = "Photometry" if "Photometry" in f else "Spectroscopy"
        for t_type, model in _iter_groups(f, top, transient_types):
            remaining = None if dataset_length is None else dataset_length - total
            if remaining is not None and remaining <= 0:
                break
            chunk = _ingest_group(
                f, t_type, model, bands, n_max_obs, n_max_obs_spec,
                want_lc, want_sp, noise, rng, remaining,
            )
            total += len(chunk["redshift"])
            yield chunk


def ingest_simulation(
    hdf5_path: str,
    bands: Sequence[str] = ("r",),
    n_max_obs: int = 100,
    n_max_obs_spec: int = 220,
    combinations: Sequence[str] = ("lightcurve",),
    noise: bool = True,
    dataset_length: Optional[int] = None,
    transient_types: Optional[Sequence[str]] = None,
    seed: int = 0,
) -> ArrayDataset:
    """Photometry/Spectroscopy HDF5 -> ArrayDataset (canonical fields).

    ``noise`` selects mag_obs/flux_obs vs mag_perfect/flux_perfect
    (dataloader.py:1155-1158, :1196-1199). ``bands`` uses the reference's
    convention: any name other than 'g' maps to the ZTF-R filter code.
    ``dataset_length`` truncates to the first N entries in group order.
    Materialises the whole corpus in host memory.
    """
    parts: Dict[str, List[np.ndarray]] = {}
    total = 0
    for chunk in iter_simulation_chunks(
        hdf5_path, bands, n_max_obs, n_max_obs_spec, combinations, noise,
        dataset_length, transient_types, seed,
    ):
        total += len(chunk["redshift"])
        for k, v in chunk.items():
            parts.setdefault(k, []).append(v)

    arrays = {k: np.concatenate(v, axis=0) for k, v in parts.items()}
    names = [f"SIM{i:07d}" for i in range(total)]
    return ArrayDataset(arrays, names)


def stream_simulation_to_cache(hdf5_path: str, cache_dir: str, rows_per_shard: int = 65536,
                               **ingest_kwargs):
    """``iter_simulation_chunks(hdf5_path, **ingest_kwargs)`` into a sharded
    cache of ``rows_per_shard`` rows a shard; returns its
    ``ShardedDataset``. Holds at most a shard and a group in host memory."""
    from .streaming import write_sharded_cache

    return write_sharded_cache(cache_dir, iter_simulation_chunks(hdf5_path, **ingest_kwargs),
                               rows_per_shard)


def _ingest_group(
    f, t_type, model, bands, n_max_obs, n_max_obs_spec,
    want_lc, want_sp, noise, rng, limit,
):
    out: Dict[str, np.ndarray] = {}
    tid_lc = tid_sp = None

    if want_lc:
        g = f["Photometry"][t_type][model]
        mjd, present = _as_matrix(g["mjd"])
        mag, _ = _as_matrix(g["mag_obs" if noise else "mag_perfect"])
        filt, _ = _as_matrix(g["filter"])
        z = np.asarray(g["z"][...], dtype=np.float32)
        tid_lc = np.asarray(g["TID"][...])
        if limit is not None:
            mjd, mag, filt, present = (
                a[:limit] for a in (mjd, mag, filt, present)
            )
            z = z[:limit]
            tid_lc = tid_lc[:limit]
        t_cat, x_cat, m_cat = [], [], []
        for band in bands:
            code = BAND_CODES.get(band, BAND_CODES["R"])
            valid = present & (filt == code)
            packed, mask = pack_ragged_rows(
                {"t": mjd, "x": mag}, valid, n_max_obs, rng, sort_by="t"
            )
            t_cat.append(zero_time_origin_rows(packed["t"], mask))
            x_cat.append(packed["x"])
            m_cat.append(mask)
        out["t_lc"] = np.concatenate(t_cat, axis=1).astype(np.float32)
        out["x_lc"] = np.concatenate(x_cat, axis=1).astype(np.float32)
        out["mask_lc"] = np.concatenate(m_cat, axis=1)
        out["err_lc"] = np.zeros_like(out["x_lc"])
        out["redshift"] = z

    if want_sp:
        g = f["Spectroscopy"][t_type][model]
        wl, present = _as_matrix(g["wavelength"])
        flux, _ = _as_matrix(g["flux_obs" if noise else "flux_perfect"])
        tid_sp = np.asarray(g["TID"][...])
        if limit is not None:
            wl, flux, present = wl[:limit], flux[:limit], present[:limit]
            tid_sp = tid_sp[:limit]
        if tid_lc is not None and not np.array_equal(tid_lc, tid_sp):
            raise ValueError(f"lightcurve/spectra TID mismatch in {t_type}/{model}")
        packed, mask = pack_ragged_rows(
            {"t": wl, "x": flux}, present, n_max_obs_spec, rng, sort_by="t"
        )
        out["t_sp"] = packed["t"].astype(np.float32)
        out["x_sp"] = packed["x"].astype(np.float32)
        out["mask_sp"] = mask
        out["err_sp"] = np.zeros_like(out["x_sp"])
        if "redshift" not in out:
            out["redshift"] = np.zeros(len(mask), np.float32)

    n = len(out["redshift"])
    out.setdefault("label", np.zeros(n, np.int32))
    return out


def ingest_simulation_lightcurves(
    hdf5_path: str,
    bands: Sequence[str] = ("r",),
    n_max_obs: int = 100,
    dataset_length: Optional[int] = None,
    transient_types: Optional[Sequence[str]] = None,
    seed: int = 0,
) -> ArrayDataset:
    """Legacy TransientTable HDF5 -> ArrayDataset (light-curve fields only).

    Reproduces ``SimulationLightcurveDataset`` semantics
    (dataloader.py:973-1034): drop mag>=98 sentinels, normalise
    ``(mag - 23.74) / 1.6``, CCM89-correct with A_V = mwebv * 3.1 at the
    band's effective wavelength, pack + per-band time zeroing.
    """
    rng = np.random.default_rng(seed)
    parts: Dict[str, List[np.ndarray]] = {}
    total = 0
    with hdf5.File(hdf5_path) as f:
        for t_type, model in _iter_groups(f, "TransientTable", transient_types):
            if dataset_length is not None and total >= dataset_length:
                break
            g = f["TransientTable"][t_type][model]
            mjd, present = _as_matrix(g["MJD"])
            mwebv = np.asarray(g["mwebv"][...], dtype=np.float64)
            limit = None if dataset_length is None else dataset_length - total
            if limit is not None:
                mjd, present, mwebv = mjd[:limit], present[:limit], mwebv[:limit]
            t_cat, x_cat, m_cat = [], [], []
            for band in bands:
                mag, _ = _as_matrix(g[f"mag_{band}"])
                if limit is not None:
                    mag = mag[:limit]
                valid = present & (mag < 98)
                norm = (mag - 23.74) / 1.6
                key = "g" if band == "g" else "R"
                ext = mwebv[:, None] * 3.1 * CCM89_UNIT_AV_RV31[key]
                norm = norm - ext
                packed, mask = pack_ragged_rows(
                    {"t": mjd, "x": norm}, valid, n_max_obs, rng, sort_by="t"
                )
                t_cat.append(zero_time_origin_rows(packed["t"], mask))
                x_cat.append(packed["x"])
                m_cat.append(mask)
            chunk = {
                "t_lc": np.concatenate(t_cat, axis=1).astype(np.float32),
                "x_lc": np.concatenate(x_cat, axis=1).astype(np.float32),
                "mask_lc": np.concatenate(m_cat, axis=1),
            }
            chunk["err_lc"] = np.zeros_like(chunk["x_lc"])
            n = len(chunk["t_lc"])
            chunk["redshift"] = np.zeros(n, np.float32)
            chunk["label"] = np.zeros(n, np.int32)
            total += n
            for k, v in chunk.items():
                parts.setdefault(k, []).append(v)
    arrays = {k: np.concatenate(v, axis=0) for k, v in parts.items()}
    return ArrayDataset(arrays, [f"SIMLC{i:07d}" for i in range(total)])
