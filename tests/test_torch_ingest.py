"""The port's host data layer against the JAX package's: the ZTF BTS ingest
(bitwise, on the fixture tree with light curves and spectra longer than their
n_max), the native CSV reader (against JAX's native reader, pandas and its
own plain version), the PNG decoder (against PIL) and the array cache (across
packages)."""

import importlib
import os
import shutil
import sys
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from fixtures import write_mini_ztfbts
from multimodal_supernovae_tpu.data import cache as jax_cache
from multimodal_supernovae_tpu.data import native as jax_native
from multimodal_supernovae_tpu.data import ztfbts as jax_ztfbts
from multimodal_supernovae_tpu_torch.data import cache, native, png, ztfbts

build_mod = importlib.import_module("multimodal_supernovae_tpu_torch.kernels.build")
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from chip_smoke import write_png  # noqa: E402

N, LC_MAX, SP_MAX = 40, 10, 30  # fixture light curves 5-29 a band, spectra 40-79 rows


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ztfbts")
    data_dir, spectra_dir, ids = write_mini_ztfbts(str(root), n=N, seed=3)
    return data_dir, spectra_dir


def _assert_same(got, want):
    assert got.filenames == want.filenames
    assert sorted(got.arrays) == sorted(want.arrays)
    for k, w in want.arrays.items():
        g = got.arrays[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(np.asarray(g).view(np.uint8), np.asarray(w).view(np.uint8),
                                      err_msg=k)


@pytest.mark.parametrize("n_classes", [3, 5])
@pytest.mark.parametrize("abs_mag", [False, True])
@pytest.mark.parametrize("combinations", [("lightcurve", "spectral"),
                                          ("host_galaxy", "lightcurve"),
                                          ("host_galaxy", "lightcurve", "spectral")])
def test_load_ztfbts_matches_jax(tree, combinations, abs_mag, n_classes):
    """Every array bitwise and the names in order, with subsampling (light
    curves and spectra longer than n_max draw from the one generator)."""
    data_dir, spectra_dir = tree
    jax_native.ensure_built()
    kw = dict(combinations=combinations, max_data_len_lc=LC_MAX, max_data_len_spec=SP_MAX,
              n_classes=n_classes, abs_mag=abs_mag, seed=7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, want_nband, want_folds = jax_ztfbts.load_ztfbts(data_dir, spectra_dir, **kw)
        got, nband, folds = ztfbts.load_ztfbts(data_dir, spectra_dir, **kw)
    assert len(got) > N // 2 and nband == want_nband == 2
    _assert_same(got, want)
    for f, w in zip(folds, want_folds):
        for k in ("train_indices", "test_indices"):
            np.testing.assert_array_equal(f[k], w[k])


def test_default_lengths_pad_and_subsample(tree):
    """At the default n_max nothing is subsampled; the arrays still match."""
    data_dir, spectra_dir = tree
    jax_native.ensure_built()
    kw = dict(combinations=("lightcurve", "spectral"), kfolds=None)
    _assert_same(ztfbts.load_ztfbts(data_dir, spectra_dir, **kw)[0],
                 jax_ztfbts.load_ztfbts(data_dir, spectra_dir, **kw)[0])


TABLE = """ZTFID,redshift,type,A_V
ZTF20a0,0.01,SN Ia,0.1
ZTF20a1,,SN II,0.2
ZTF20a2,NA,SN Ib,0.3
ZTF20a3,abc,SN Ic,0.1
ZTF20a4,0.05,,0.2
ZTF20a5,0.06,None,0.0
ZTF20a6,0.07,TDE,0.1
ZTF20a7,1e-2,SN IIn,0.1
ZTF20a8,null,SLSN-I,0.2
ZTF20a9,0.09,SN IIP,0.3
ZTF20a0,0.11,SN Ia,0.1
"""


def test_transient_table_matches_pandas(tmp_path):
    """Empty and pandas-missing cells, a word among the redshifts, a missing
    type, an unknown type and a duplicate id: the redshifts and classes
    (in table order) are the JAX package's (pandas)."""
    (tmp_path / "ZTFBTS_TransientTable.csv").write_text(TABLE)
    names = [f"ZTF20a{i}" for i in range(10)]
    for n_classes in (3, 5):
        g, w = (ztfbts.load_classes(str(tmp_path), n_classes, names),
                jax_ztfbts.load_classes(str(tmp_path), n_classes, names))
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1] == w[1]
    g, w = ztfbts.load_redshifts(str(tmp_path), names), jax_ztfbts.load_redshifts(
        str(tmp_path), names)
    assert g[1] == w[1] == ["ZTF20a0", "ZTF20a4", "ZTF20a5", "ZTF20a6", "ZTF20a7", "ZTF20a9",
                            "ZTF20a0"]
    np.testing.assert_array_equal(g[0], w[0])
    assert g[0].dtype == w[0].dtype == np.float32


def _csv_files(tree):
    data_dir, spectra_dir = tree
    lcs = sorted(Path(data_dir, "light-curves").glob("*.csv"))
    return ([(Path(data_dir, "ZTFBTS_TransientTable.csv"), True)]
            + [(p, True) for p in lcs]
            + [(p, False) for p in sorted(Path(spectra_dir).glob("*.csv"))])


def _same_columns(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype == object:
            assert g.tolist() == w.tolist(), k
        else:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
            np.testing.assert_array_equal(g[~np.isnan(g)].view(np.int64),
                                          w[~np.isnan(w)].view(np.int64), err_msg=k)


def test_fastcsv_matches_the_jax_native_reader_and_its_plain_version(tree):
    assert jax_native.ensure_built() and jax_native.available()
    files = _csv_files(tree)
    assert len(files) > 2 * N - 5
    for path, header in files:
        got = native.read_csv(str(path), header)
        _same_columns(got, jax_native.read_csv(str(path), header))
        _same_columns(got, native.read_csv_plain(str(path), header))


def test_fastcsv_matches_pandas_on_the_fixtures(tree):
    """Numeric columns equal pandas' floats, string columns its strings."""
    for path, header in _csv_files(tree):
        got = native.read_csv(str(path), header)
        df = pd.read_csv(path, header=0 if header else None)
        assert list(got) == [str(c) for c in df.columns]
        for name, col in zip(got, df.columns):
            want = df[col].to_numpy()
            if got[name].dtype == object:
                assert got[name].tolist() == [str(x) for x in want]
            else:
                np.testing.assert_array_equal(got[name], want.astype(np.float64))


EDGE_CSVS = {
    "mixed": "a,b\n1,x\n2,3\n",
    "empty_cells": "a,b,c\n1,,\n,2,\n3,4,NA\n",
    "crlf_blank_spaces": "a,b\r\n\r\n 1 , y \r\n\n2,z\r\n",
    "short_and_long_rows": "a,b,c\n1\n2,3,4,5\n",
    "words": "x,y\nnan,inf\nNaN,-inf\n1e400,1_0\n",
    "header_only": "a,b\n",
    "empty": "",
}


@pytest.mark.parametrize("name", sorted(EDGE_CSVS))
@pytest.mark.parametrize("header", [True, False])
def test_fastcsv_edges_against_the_jax_reader_and_plain(tmp_path, name, header):
    """A mixed column becomes strings as a whole; empty cells are NaN in a
    numeric column and empty strings in a string one; the first line fixes
    the columns."""
    jax_native.ensure_built()
    path = tmp_path / f"{name}.csv"
    path.write_text(EDGE_CSVS[name])
    got = native.read_csv(str(path), header)
    _same_columns(got, jax_native.read_csv(str(path), header))
    _same_columns(got, native.read_csv_plain(str(path), header))


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No fallback: a source that does not compile, or no host compiler,
    raises from the first use."""
    for f in build_mod.CSRC_DIR.iterdir():
        if f.is_file():
            shutil.copy(f, tmp_path / f.name)
    (tmp_path / "fastcsv.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build_mod, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build_mod, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed on csrc/fastcsv.cpp"):
        native.ensure_built()
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="host C\\+\\+ compiler"):
        native.read_csv(str(tmp_path / "fastcsv.cpp"))


def test_fastcsv_builds_into_the_kernel_build_dir():
    native.ensure_built()
    path = build_mod.library_path("fastcsv")
    assert path.parent == build_mod.BUILD_DIR and path.exists()
    assert path.name.startswith("libfastcsv-")
    assert path != build_mod.library_path("flash_attention_fwd")


# ---- PNG ----------------------------------------------------------------

def _pil_rgb(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_decode_matches_pil_on_files_pil_writes(tmp_path, mode):
    rng = np.random.default_rng(len(mode))
    shape = {"RGB": (20, 17, 3), "RGBA": (13, 20, 4), "L": (20, 20), "LA": (9, 20, 2),
             "P": (20, 21)}[mode]
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    img = Image.fromarray(arr, mode if mode != "P" else "L")
    if mode == "P":  # 256 colours, so PIL writes 8-bit indices
        img = Image.fromarray(arr, "P")
        img.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tolist())
    path = tmp_path / f"{mode}.png"
    img.save(path)
    want = _pil_rgb(path)
    got = png.load_rgb(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.load_rgb(str(path), png.unfilter_numpy), want)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("channels", [1, 2, 3, 4, "palette"])
def test_png_decode_matches_pil_with_each_filter_forced(tmp_path, filt, channels):
    rng = np.random.default_rng(5)
    h, w = 11, 13
    palette = None
    if channels == "palette":
        palette = rng.integers(0, 256, (200, 3), dtype=np.uint8)
        pix = rng.integers(0, 200, (h, w), dtype=np.uint8)
    else:
        pix = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    write_png(str(path), pix, filt if isinstance(filt, tuple) else (filt,), palette=palette)
    want = _pil_rgb(path)
    np.testing.assert_array_equal(png.load_rgb(str(path)), want)
    np.testing.assert_array_equal(png.load_rgb(str(path), png.unfilter_numpy), want)
    rows = np.frombuffer(png.parse(path.read_bytes())[2], np.uint8).reshape(h, -1)[:, 0]
    assert set(rows.tolist()) == set(filt if isinstance(filt, tuple) else (filt,))


def test_png_refuses_interlaced_and_16_bit(tmp_path):
    path = tmp_path / "i.png"
    write_png(str(path), np.zeros((4, 4, 3), np.uint8), interlace=1)
    with pytest.raises(png.PNGError, match="interlaced"):
        png.load_rgb(str(path))
    Image.fromarray(np.arange(16, dtype=np.uint16).reshape(4, 4) * 1000).save(tmp_path / "d.png")
    with pytest.raises(png.PNGError, match="bit depth 16"):
        png.load_rgb(str(tmp_path / "d.png"))
    data = bytearray((tmp_path / "i.png").read_bytes())
    data[20] ^= 1  # a byte of IHDR: its CRC no longer holds
    with pytest.raises(png.PNGError, match="CRC"):
        png.decode(bytes(data))


def test_images_are_pils_divided_by_255(tree):
    """The ingest's float32 images are PIL's bytes / 255.0, bitwise."""
    data_dir, _ = tree
    got, names = ztfbts.load_images(data_dir)
    want, want_names = jax_ztfbts.load_images(data_dir)
    assert names == want_names and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ---- cache --------------------------------------------------------------

def test_cache_loads_across_packages(tree, tmp_path):
    """The same ingest config gives the same key; a cache written by either
    package loads in the other, bitwise and mmapped."""
    data_dir, spectra_dir = tree
    config = dict(data_dir=data_dir, spectra_dir=spectra_dir,
                  combinations=("lightcurve", "spectral"), max_data_len_lc=LC_MAX,
                  max_data_len_spec=SP_MAX, n_classes=5, spectral_rescalefactor=1e14)
    key = cache.cache_key(**config)
    assert key == jax_cache.cache_key(**config)
    assert cache.cache_key(kind="ztfbts-lc", **config) == jax_cache.cache_key(
        kind="ztfbts-lc", **config) != key
    jax_native.ensure_built()
    jds = jax_ztfbts.load_ztfbts(kfolds=None, **config)[0]
    pds = ztfbts.load_ztfbts(kfolds=None, **config)[0]
    jax_cache.save_dataset(str(tmp_path / "j"), jds, key)
    cache.save_dataset(str(tmp_path / "p"), pds, key)
    assert sorted(os.listdir(tmp_path / "j" / key)) == sorted(os.listdir(tmp_path / "p" / key))
    got = cache.load_dataset(str(tmp_path / "j"), key)
    assert all(isinstance(v, np.memmap) for v in got.arrays.values())
    _assert_same(got, jds)
    _assert_same(jax_cache.load_dataset(str(tmp_path / "p"), key), pds)
    calls = []
    ds, hit = cache.load_or_ingest(str(tmp_path / "j"), lambda: calls.append(1), **config)
    assert hit and not calls
    _assert_same(ds, jds)
    assert cache.load_dataset(str(tmp_path / "none"), key) is None
