"""The port's HDF5 reader (``data/hdf5.py``) against h5py: every array, its
dtype and shape, and every group's ``keys()`` on files h5py writes in each
variant the reader takes (``libver`` "earliest" and "latest"; contiguous,
compact and chunked storage with deflate and shuffle, chunks that do not
divide the shape, each chunk index; integer and float types of either byte
order; vlen rows; scalars; groups of 3, 12 and 300 members), and
``UnsupportedHDF5`` naming what it found on each variant it refuses."""

import re

import numpy as np
import pytest

import h5py
from multimodal_supernovae_tpu_torch.data import hdf5

LIBVERS = ("earliest", "latest")
CHUNKED = ("plain", "gzip", "shuffle", "both", "single", "single_gz", "implicit", "many",
           "fillpart", "fillchunk", "edge_unwritten")
DATASETS = ("c_f8", "c_f4", "c_i4", "c_i8", "c_u1", "c_be", "c_be_i2", "scalar", "scalar_i",
            "compact", "fillnone", "vlen", "vlen_chunk", "attrs") + tuple(
                f"chunks/{n}" for n in CHUNKED)
GROUPS = ("/", "chunks", "members3", "members12", "members300", "tracked", "tracked_dense",
          "nested/a/b")


def _dcpl(layout=None, chunk=None, early=False):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if layout is not None:
        dcpl.set_layout(layout)
    if chunk is not None:
        dcpl.set_chunk(chunk)
    if early:
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


def write_variants(f):
    rng = np.random.default_rng(0)
    f["c_f8"] = rng.random((7, 5))
    f["c_f4"] = rng.random((5,)).astype(np.float32)
    f["c_i4"] = rng.integers(-100, 100, (9,)).astype(np.int32)
    f["c_i8"] = rng.integers(-(2 ** 40), 2 ** 40, (3, 4))
    f["c_u1"] = rng.integers(0, 255, (4, 6)).astype(np.uint8)
    f["c_be"] = rng.random((4, 3)).astype(">f8")
    f["c_be_i2"] = rng.integers(-300, 300, (6,)).astype(">i2")
    f["scalar"] = 2.5
    f["scalar_i"] = np.int64(-7)
    f.create_dataset("compact", data=rng.random((3, 4)), dcpl=_dcpl(h5py.h5d.COMPACT))
    f.create_dataset("fillnone", shape=(6, 3), fillvalue=4.0)
    g = f.create_group("chunks")
    x = rng.random((37, 23))
    g.create_dataset("plain", data=x, chunks=(8, 5))
    g.create_dataset("gzip", data=x, chunks=(8, 5), compression="gzip")
    g.create_dataset("shuffle", data=x.astype(np.float32), chunks=(8, 5), shuffle=True)
    g.create_dataset("both", data=(1000 * x).astype(np.int32), chunks=(10, 23),
                     compression="gzip", shuffle=True)
    g.create_dataset("single", data=x, chunks=x.shape)
    g.create_dataset("single_gz", data=x, chunks=x.shape, compression="gzip", shuffle=True)
    d = g.create_dataset("implicit", shape=(10, 9), dtype=np.float64,
                         dcpl=_dcpl(chunk=(4, 4), early=True))
    d[...] = x[:10, :9]
    g.create_dataset("many", data=rng.random((3000, 3)), chunks=(1, 3))  # paged
    d = g.create_dataset("fillpart", shape=(3000, 3), chunks=(1, 3), fillvalue=-1.5)
    d[5] = [1, 2, 3]
    d[2999] = [4, 5, 6]
    g.create_dataset("fillchunk", shape=(6, 3), chunks=(2, 2), fillvalue=9, dtype=np.int32)
    d = g.create_dataset("edge_unwritten", shape=(9, 7), chunks=(4, 4), dtype=np.float32,
                         compression="gzip")
    d[:4, :4] = 1.0
    vl = f.create_dataset("vlen", (6,), dtype=h5py.vlen_dtype(np.float64))
    for i in range(6):
        vl[i] = rng.random(i * 3)
    vc = f.create_dataset("vlen_chunk", (40,), dtype=h5py.vlen_dtype(np.int32),
                          chunks=(7,), compression="gzip")
    for i in range(40):
        vc[i] = rng.integers(0, 9, i % 5)
    a = f.create_dataset("attrs", data=np.arange(12.0).reshape(3, 4))
    for i in range(40):  # the header outgrows its first block: continuation
        a.attrs[f"a{i}"] = np.arange(20.0)
    for n in (3, 12, 300):  # 300 under "latest": dense link storage
        members = f.create_group(f"members{n}")
        for i in rng.permutation(n):
            members[f"m{i:03d}"] = np.arange(i % 4 + 1)
    t = f.create_group("tracked", track_order=True)
    for name in ("zeta", "alpha", "mid"):
        t[name] = np.arange(2)
    t = f.create_group("tracked_dense", track_order=True)
    for i in rng.permutation(20):
        t[f"x{i}"] = np.arange(1)
    f["nested/a/b/leaf"] = np.arange(3)
    f["nested/a/b/Upper"] = np.arange(2)


@pytest.fixture(scope="module", params=LIBVERS)
def variants(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("h5") / f"variants-{request.param}.h5"
    with h5py.File(path, "w", libver=request.param) as f:
        write_variants(f)
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        yield request.param, ref, got


def assert_same(want, got, name):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if want.dtype == object:
        for u, v in zip(want.ravel(), got.ravel()):
            assert v.dtype == u.dtype and np.array_equal(u, v), name
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_superblock_versions(variants):
    libver, _, got = variants
    with open(got.filename, "rb") as fh:
        assert fh.read(9)[8] == {"earliest": 0, "latest": 3}[libver]


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_equals_h5py(variants, name):
    _, ref, got = variants
    d = got[name]
    assert isinstance(d, hdf5.Dataset)
    assert d.shape == ref[name].shape and d.dtype == ref[name].dtype
    assert_same(ref[name][...], d[...], name)
    assert_same(ref[name][()], d[()], name)


@pytest.mark.parametrize("group", GROUPS)
def test_keys_equal_h5py(variants, group):
    _, ref, got = variants
    assert got[group].keys() == list(ref[group].keys())
    assert list(got[group]) == list(ref[group]) and len(got[group]) == len(ref[group])


def walk(ref, got, path=""):
    """The whole tree: keys, then every array."""
    assert got.keys() == list(ref.keys()), path
    for k in ref.keys():
        if isinstance(ref[k], h5py.Group):
            walk(ref[k], got[k], f"{path}/{k}")
        else:
            assert_same(ref[k][...], got[k][...], f"{path}/{k}")


def test_every_member_equals_h5py(variants):
    _, ref, got = variants
    walk(ref, got)


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("offsets,lengths", [(4, 4), (4, 8), (8, 4)])
def test_other_offset_and_length_sizes(tmp_path, libver, offsets, lengths):
    """Files whose addresses or lengths take 4 bytes, not h5py's 8: every
    field sized by the superblock (symbol table entries, the global heap's
    padded headers, vlen records, chunk indexes) read as h5py reads it."""
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(offsets, lengths)
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    low = h5py.h5f.LIBVER_EARLIEST if libver == "earliest" else h5py.h5f.LIBVER_LATEST
    fapl.set_libver_bounds(low, h5py.h5f.LIBVER_LATEST)
    path = tmp_path / "sizes.h5"
    with h5py.File(h5py.h5f.create(bytes(path), h5py.h5f.ACC_TRUNC, fcpl=fcpl,
                                   fapl=fapl)) as f:
        write_variants(f)
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        assert (got._reader.o, got._reader.l) == (offsets, lengths)
        walk(ref, got)


def test_chunk_indexes_are_the_ones_named(variants):
    """Under "latest" the chunked datasets take every index the reader
    reads: single chunk (1), implicit (2), fixed array (3); under
    "earliest" the v1 B-tree (layout version 3)."""
    libver, _, got = variants
    layouts = {n: got[f"chunks/{n}"]._layout for n in ("plain", "single", "implicit", "many")}
    if libver == "earliest":
        assert {b[0] for b in layouts.values()} == {3}
    else:
        index = {n: b[5 + b[3] * b[4]] for n, b in layouts.items()}
        assert index == {"plain": 3, "single": 1, "implicit": 2, "many": 3}


def test_paths_and_membership(variants):
    _, ref, got = variants
    assert "chunks" in got and "chunks/gzip" in got and "/chunks/gzip" in got
    assert "nope" not in got and "chunks/nope" not in got and "c_f8/x" not in got
    np.testing.assert_array_equal(got["nested"]["a/b"]["leaf"][...], ref["nested/a/b/leaf"][...])
    np.testing.assert_array_equal(got["/nested/a/b/Upper"][...], [0, 1])
    with pytest.raises(KeyError):
        got["chunks/nope"]
    assert got["c_f8"].shape == (7, 5) and got["c_f8"].size == 35


@pytest.fixture(scope="module")
def refused(tmp_path_factory):
    path = tmp_path_factory.mktemp("h5") / "refused.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("fletcher32", data=np.arange(10.0), chunks=(5,), fletcher32=True)
        if h5py.h5z.filter_avail(32000):
            f.create_dataset("lzf", data=np.arange(10.0), chunks=(5,), compression="lzf")
        f.create_dataset("scaleoffset", data=np.arange(10), chunks=(5,), scaleoffset=0)
        f.create_dataset("unlimited", data=np.ones((4, 3)), maxshape=(None, 3))
        f.create_dataset("unlimited2", data=np.ones((4, 3)), maxshape=(None, None))
        f["target"] = np.arange(3.0)
        f["soft"] = h5py.SoftLink("/target")
        f["external"] = h5py.ExternalLink("other.h5", "/x")
        f["string"] = "hello"
        f["bytes"] = np.array([b"ab", b"cd"])
        f["bools"] = np.array([True, False])
        f["compound"] = np.zeros(3, dtype=[("a", "<f8"), ("b", "<i4")])
        f["half"] = np.zeros(3, np.float16)
    return path


@pytest.mark.parametrize("name,named", [
    ("fletcher32", "filter 3 (fletcher32)"), ("lzf", "filter 32000 (lzf)"),
    ("scaleoffset", "filter 6 (scaleoffset)"),
    ("unlimited", "extensible array chunk index"), ("unlimited2", "v2 B-tree chunk index"),
    ("soft", "soft link to /target"), ("external", "external link to other.h5"),
    ("string", "variable-length string"), ("bytes", "class 3 (string)"),
    ("bools", "class 8 (enum)"), ("compound", "class 6 (compound)"),
    ("half", "floating-point datatype of 2 bytes")])
def test_unsupported_layouts_raise_naming_them(refused, name, named):
    if name == "lzf" and not h5py.h5z.filter_avail(32000):
        pytest.skip("this h5py has no lzf filter")
    with hdf5.File(refused) as f:
        assert name in f.keys()
        with pytest.raises(hdf5.UnsupportedHDF5, match=re.escape(named)):
            f[name][...]
        np.testing.assert_array_equal(f["target"][...], [0.0, 1.0, 2.0])


def test_soft_link_raises_under_earliest_too(tmp_path):
    path = tmp_path / "soft.h5"
    with h5py.File(path, "w", libver="earliest") as f:
        f["a"] = np.arange(3.0)
        f["soft"] = h5py.SoftLink("/a")
        f.create_dataset("unlimited", data=np.ones((4, 3)), maxshape=(None, 3))
    with hdf5.File(path) as f:
        assert f.keys() == ["a", "soft", "unlimited"]
        with pytest.raises(hdf5.UnsupportedHDF5, match="soft link to /a"):
            f["soft"]
        # an unlimited dimension under "earliest" is a v1 B-tree: read
        np.testing.assert_array_equal(f["unlimited"][...], np.ones((4, 3)))


@pytest.mark.parametrize("kind", ["userblock", "superblock2"])
def test_userblock_and_superblock_2(tmp_path, kind):
    path = tmp_path / f"{kind}.h5"
    kw = {"userblock_size": 512} if kind == "userblock" else {"libver": ("v108", "v108")}
    with h5py.File(path, "w", **kw) as f:
        f["x"] = np.arange(5.0)
        f.create_dataset("g/c", data=np.arange(50.0), chunks=(7,), compression="gzip")
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        assert got.keys() == list(ref.keys()) == ["g", "x"]
        assert_same(ref["x"][...], got["x"][...], "x")
        assert_same(ref["g/c"][...], got["g/c"][...], "g/c")
    with open(path, "rb") as fh:
        head = fh.read(1024)
    at = head.index(hdf5.SIGNATURE)
    assert (at, head[at + 8]) == ((512, 0) if kind == "userblock" else (0, 2))


def test_refuses_other_files_and_modes(tmp_path):
    path = tmp_path / "not.h5"
    path.write_bytes(b"\0" * 2048)
    with pytest.raises(hdf5.UnsupportedHDF5, match="no HDF5 signature"):
        hdf5.File(path)
    with pytest.raises(ValueError, match="read-only"):
        hdf5.File(path, "w")
