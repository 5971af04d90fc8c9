"""The port's simulation ingest (``data/simulation.py`` on its own HDF5
reader, ``transforms.pack_ragged_rows``) bitwise against the JAX package's
(on h5py) on the mini corpus of ``tests/fixtures.py``, a vlen and a chunked
copy of it, the smoke's own HDF5 writer's files and a legacy TransientTable
file; and ``cli.pretrain_sim`` against the JAX CLI: its run files, its cache
(the same key; each package loads the other's), its split manifests,
``--resume``, ``--check`` and ``--streaming``."""

import json
import os
import sys
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import yaml

import h5py
from fixtures import write_mini_sim_hdf5
from multimodal_supernovae_tpu.cli import pretrain_sim as jax_pretrain_sim
from multimodal_supernovae_tpu.data import simulation as jax_sim
from multimodal_supernovae_tpu.data import transforms as jax_transforms
from multimodal_supernovae_tpu.data.cache import load_dataset as jax_load_dataset
from multimodal_supernovae_tpu.data.folds import split_for_run as jax_split_for_run
from multimodal_supernovae_tpu_torch.cli import pretrain_sim
from multimodal_supernovae_tpu_torch.data import simulation, transforms
from multimodal_supernovae_tpu_torch.data.cache import load_dataset

REPO = Path(__file__).resolve().parent.parent
MAVEN_PRETRAIN = REPO / "configs" / "maven_pretrain.yaml"
RUN_FILES = {"config.yaml", "train_filenames.txt", "val_filenames.txt", "model_config.json",
             "metrics.jsonl", "summary.json", "last.ckpt"}


def assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = np.asarray(got[k])
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert np.array_equal(g.view(np.uint8), np.asarray(v).view(np.uint8)), k


@pytest.mark.parametrize("seed,n,width,n_max,frac,sort_by", [
    (0, 6, 10, 4, 0.7, "t"), (1, 9, 12, 12, 0.5, "t"), (2, 5, 8, 20, 0.9, "t"),
    (3, 7, 30, 6, 1.0, None), (4, 1, 5, 3, 0.0, "t"), (5, 40, 220, 100, 0.55, "t")])
def test_pack_ragged_rows_is_jax_bitwise(seed, n, width, n_max, frac, sort_by):
    """The same packed values, mask and generator state after: oversize
    rows subsampled, undersize padded, n_max past the width, empty rows."""
    data = np.random.default_rng(100 + seed)
    values = {"t": np.sort(data.random((n, width)) * 50, axis=1),
              "x": data.normal(size=(n, width))}
    valid = data.random((n, width)) < frac
    rngs = [np.random.default_rng(seed), np.random.default_rng(seed)]
    want = jax_transforms.pack_ragged_rows(values, valid, n_max, rngs[0], sort_by=sort_by)
    got = transforms.pack_ragged_rows(values, valid, n_max, rngs[1], sort_by=sort_by)
    assert_bitwise(got[0], want[0])
    assert_bitwise({"mask": got[1]}, {"mask": want[1]})
    assert rngs[0].bit_generator.state == rngs[1].bit_generator.state
    t = got[0]["t"]
    assert_bitwise({"t": transforms.zero_time_origin_rows(t, got[1])},
                   {"t": jax_transforms.zero_time_origin_rows(t, want[1])})


def _copy(src, dst, libver="earliest", vlen=False, **chunking):
    """A copy of the mini corpus: each (N, L) matrix as vlen rows cut to
    lengths shared by a group's matrices, or chunked with ``chunking``."""
    rng = np.random.default_rng(7)
    with h5py.File(src, "r") as f, h5py.File(dst, "w", libver=libver) as g:
        def visit(name, obj):
            if not isinstance(obj, h5py.Group) or not any(
                    isinstance(v, h5py.Dataset) for v in obj.values()):
                return
            cut = None
            for key, dset in obj.items():
                arr = dset[...]
                if vlen and arr.ndim == 2:
                    if cut is None:
                        cut = rng.integers(arr.shape[1] // 3, arr.shape[1] + 1, len(arr))
                    d = g.create_dataset(f"{name}/{key}", (len(arr),),
                                         dtype=h5py.vlen_dtype(arr.dtype))
                    for i, row in enumerate(arr):
                        d[i] = row[:cut[i]]
                elif chunking and arr.ndim == 2:
                    g.create_dataset(f"{name}/{key}", data=arr, **chunking)
                else:
                    g[f"{name}/{key}"] = arr

        f.visititems(visit)


@pytest.fixture(scope="module")
def sim_files(tmp_path_factory):
    """The mini corpus (h5py's default layout), its vlen copy, its chunked
    copy (libver latest, deflate and shuffle, chunks that do not divide the
    shape) and a corpus written by chip_smoke.write_sim_hdf5."""
    import chip_smoke

    root = tmp_path_factory.mktemp("sim")
    plain = str(root / "plain.h5")
    write_mini_sim_hdf5(plain, n_per_type=8, lc_len=40, sp_len=30)
    files = {"plain": plain, "vlen": str(root / "vlen.h5"), "chunked": str(root / "chunked.h5"),
             "smoke": str(root / "smoke.h5")}
    _copy(plain, files["vlen"], vlen=True)
    _copy(plain, files["chunked"], libver="latest", chunks=(3, 7), compression="gzip",
          shuffle=True)
    with mock.patch.object(chip_smoke, "SIM_LC_POINTS", 40), \
            mock.patch.object(chip_smoke, "SIM_WAVELENGTHS", 30):
        groups = chip_smoke._sim_corpus((2, 3, 6), seed=0)
    chip_smoke.write_sim_hdf5(files["smoke"], groups)
    return files, groups


CASES = {
    "both-noise": dict(bands=("r", "g"), combinations=("lightcurve", "spectral"), noise=True),
    "both-perfect": dict(bands=("r", "g"), combinations=("lightcurve", "spectral"), noise=False),
    "lc-g": dict(bands=("g",), combinations=("lightcurve",)),
    "lc-cut-inside": dict(bands=("r", "g"), combinations=("lightcurve",), noise=False,
                          dataset_length=11),
    "both-cut-types": dict(bands=("r", "g"), combinations=("lightcurve", "spectral"),
                           dataset_length=5, transient_types=["Ia", "II"]),
    "sp-only": dict(combinations=("spectral",), seed=3),
    "sp-padded": dict(combinations=("lightcurve", "spectral"), n_max_obs_spec=45,
                      transient_types=["II"]),
}


@pytest.mark.parametrize("variant", ["plain", "vlen", "chunked", "smoke"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ingest_simulation_is_jax_bitwise(sim_files, variant, case):
    files, _ = sim_files
    kw = dict(n_max_obs=16, n_max_obs_spec=20)
    kw.update(CASES[case])
    if variant == "smoke" and kw.get("transient_types"):
        kw["transient_types"] = ["type1"]
    want = jax_sim.ingest_simulation(files[variant], **kw)
    got = simulation.ingest_simulation(files[variant], **kw)
    assert_bitwise(got.arrays, want.arrays)
    assert got.filenames == want.filenames and len(got) > 0


@pytest.mark.parametrize("variant", ["plain", "vlen", "chunked", "smoke"])
@pytest.mark.parametrize("dataset_length", [None, 11])
def test_iter_simulation_chunks_is_jax_bitwise(sim_files, variant, dataset_length):
    """The same chunks, one a model group, cut at the same place."""
    files, _ = sim_files
    kw = dict(bands=("r", "g"), n_max_obs=16, n_max_obs_spec=20,
              combinations=("lightcurve", "spectral"), dataset_length=dataset_length)
    want = list(jax_sim.iter_simulation_chunks(files[variant], **kw))
    got = list(simulation.iter_simulation_chunks(files[variant], **kw))
    assert [len(c["redshift"]) for c in got] == [len(c["redshift"]) for c in want]
    for g, w in zip(got, want):
        assert_bitwise(g, w)


def test_smoke_writer_reads_back_through_h5py(sim_files):
    """chip_smoke.write_sim_hdf5's file holds what it was handed (h5py reads
    it), and the smoke's own check of the ingest (_sim_expected) holds."""
    import chip_smoke

    files, groups = sim_files
    with h5py.File(files["smoke"], "r") as f:
        assert sorted(f.keys()) == ["Photometry", "Spectroscopy"]
        for path, arrays in groups.items():
            assert sorted(f[path].keys()) == sorted(arrays)
            for k, v in arrays.items():
                assert f[path][k].dtype == v.dtype
                np.testing.assert_array_equal(f[path][k][...], v)
    config = pretrain_sim.ingest_config(files["smoke"], {"combinations": ["lightcurve",
                                                                          "spectral"]})
    got = simulation.ingest_simulation(**config)
    assert chip_smoke._bitwise(got.arrays, chip_smoke._sim_expected(groups, config))


def test_smoke_legacy_writer_and_sentinels(tmp_path):
    import chip_smoke

    groups = chip_smoke._sim_legacy((2, 2, 7), seed=1)
    path = str(tmp_path / "legacy.h5")
    chip_smoke.write_sim_hdf5(path, groups)
    with h5py.File(path, "r") as f:
        for gpath, arrays in groups.items():
            for k, v in arrays.items():
                np.testing.assert_array_equal(f[gpath][k][...], v)
    for kw in (dict(bands=("r", "g"), n_max_obs=64), dict(bands=("g",), n_max_obs=20,
                                                          dataset_length=10)):
        assert_bitwise(simulation.ingest_simulation_lightcurves(path, **kw).arrays,
                       jax_sim.ingest_simulation_lightcurves(path, **kw).arrays)


@pytest.fixture(scope="module")
def legacy_file(tmp_path_factory):
    """A TransientTable corpus by h5py: three types, two models each, with
    not-observed sentinels (mag >= 98)."""
    path = tmp_path_factory.mktemp("simlc") / "legacy.h5"
    rng = np.random.default_rng(1)
    with h5py.File(path, "w") as f:
        for t_type in ("SNIa", "SNII", "SLSN"):
            for model in ("model0", "model1"):
                g = f.create_group(f"TransientTable/{t_type}/{model}")
                n, L = int(rng.integers(3, 7)), 30
                g["MJD"] = np.sort(rng.random((n, L)) * 50, axis=1)
                for band in ("r", "g"):
                    mag = 23 + rng.normal(size=(n, L))
                    mag[rng.random((n, L)) < 0.2] = 99.0
                    g[f"mag_{band}"] = mag
                g["mwebv"] = rng.random(n) * 0.1
    return str(path)


@pytest.mark.parametrize("kw", [
    dict(bands=("r",), n_max_obs=32), dict(bands=("r", "g"), n_max_obs=16),
    dict(bands=("g",), n_max_obs=8, seed=4), dict(bands=("r", "g"), dataset_length=9),
    dict(bands=("r", "g"), transient_types=["SNII", "SLSN"], dataset_length=7)],
    ids=["r", "rg", "g-seed", "cut", "types-cut"])
def test_ingest_simulation_lightcurves_is_jax_bitwise(legacy_file, kw):
    want = jax_sim.ingest_simulation_lightcurves(legacy_file, **kw)
    got = simulation.ingest_simulation_lightcurves(legacy_file, **kw)
    assert_bitwise(got.arrays, want.arrays)
    assert got.filenames == want.filenames


def test_stream_simulation_to_cache_raises_with_its_item(sim_files, tmp_path):
    """Ported (item 17b): the sharded cache of each corpus variant byte for
    byte the JAX package's, its rows the in-memory ingest's
    (tests/test_torch_streaming.py holds the writer)."""
    files, _ = sim_files
    for name, path in files.items():
        kw = CASES["both-noise"]
        jax_sim.stream_simulation_to_cache(path, str(tmp_path / f"jax-{name}"),
                                           rows_per_shard=5, **kw)
        sds = simulation.stream_simulation_to_cache(path, str(tmp_path / f"port-{name}"),
                                                    rows_per_shard=5, **kw)
        for root, _, names in os.walk(tmp_path / f"jax-{name}"):
            for f in names:
                want = os.path.join(root, f)
                got = want.replace(f"jax-{name}", f"port-{name}")
                assert open(got, "rb").read() == open(want, "rb").read(), (name, f)
        assert_bitwise(sds.materialize().arrays,
                       simulation.ingest_simulation(path, **kw).arrays)


# ---- cli.pretrain_sim against the JAX CLI -------------------------------------


@pytest.fixture(scope="module")
def sim_runs(tmp_path_factory):
    """A small copy of configs/maven_pretrain.yaml (one block a tower, B = 8,
    T_sp = 20) trained one epoch on the mini corpus by the port's CLI (on the
    CPU) and by the JAX CLI, each with its own cache."""
    root = tmp_path_factory.mktemp("pretrain_sim")
    raw = yaml.safe_load(MAVEN_PRETRAIN.read_text())
    small = {"transformer_depth": 1, "transformer_depth_spectral": 1, "emb": 16,
             "heads": 2, "emb_spectral": 16, "heads_spectral": 2, "batchsize": 8}
    raw["parameters"].update({k: {"values": [v]} for k, v in small.items()})
    raw["extra_args"].update(max_spectral_data_len=20, max_lightcurve_data_len=12)
    config = root / "maven_pretrain.yaml"
    config.write_text(yaml.safe_dump(raw))
    data_dir = root / "sim"
    data_dir.mkdir()
    write_mini_sim_hdf5(str(data_dir / raw["extra_args"]["filename_trainset"]), n_per_type=12)
    common = [str(config), "--data-dir", str(data_dir), "--epochs", "1"]
    pretrain_sim.main([*common, "--cache-dir", str(root / "cache-port"), "--analysis-path",
                       str(root / "port"), "--device", "cpu"])
    with warnings.catch_warnings(), mock.patch.dict(os.environ, {"MMSN_COMPILE_CACHE": "0"}), \
            mock.patch.object(sys, "argv", ["pretrain_sim.py", *common, "--cache-dir",
                                            str(root / "cache-jax"), "--analysis-path",
                                            str(root / "jax"), "--platform", "cpu"]):
        warnings.simplefilter("ignore")
        jax_pretrain_sim.main()
    return root, common


def test_pretrain_sim_writes_the_run_files(sim_runs):
    root, _ = sim_runs
    sweep_dir = root / "port" / "maven_pretrain"
    assert sorted(os.listdir(sweep_dir)) == ["run-0", "sweep_config.yaml"]
    files = set(os.listdir(sweep_dir / "run-0"))
    assert RUN_FILES <= files and any(f.startswith("epoch=") for f in files)
    rows = [json.loads(line) for line in open(sweep_dir / "run-0" / "metrics.jsonl")]
    assert [r["epoch"] for r in rows] == [0] and np.isfinite(rows[0]["val_loss"])


def test_pretrain_sim_cache_is_jax(sim_runs, capsys):
    """The same cache key as the JAX CLI's; each package loads the other's
    cache bitwise, and the port's CLI hits the JAX CLI's cache."""
    root, common = sim_runs
    keys = os.listdir(root / "cache-port")
    assert keys == os.listdir(root / "cache-jax") and len(keys) == 1
    port, jax_ = load_dataset(str(root / "cache-jax"), keys[0]), jax_load_dataset(
        str(root / "cache-port"), keys[0])
    assert_bitwise(port.arrays, jax_.arrays)
    assert port.filenames == jax_.filenames
    capsys.readouterr()
    pretrain_sim.main([*common, "--cache-dir", str(root / "cache-jax"), "--analysis-path",
                       str(root / "port-on-jax-cache"), "--device", "cpu"])
    assert "cache=hit" in capsys.readouterr().out


def test_pretrain_sim_manifests_are_jax_split(sim_runs):
    """The port's manifests are split_for_run's random split (val_fraction
    0.05, seed 0) of the JAX ingest, and the JAX CLI's own."""
    root, _ = sim_runs
    ds = jax_load_dataset(str(root / "cache-jax"), os.listdir(root / "cache-jax")[0])
    tr, va = jax_split_for_run(len(ds), 0.05, 0)
    for fname, idx in (("train_filenames.txt", tr), ("val_filenames.txt", va)):
        got = (root / "port" / "maven_pretrain" / "run-0" / fname).read_text().splitlines()
        assert got == [ds.filenames[i] for i in idx]
        assert got == (root / "jax" / "maven_pretrain" / "run-0" / fname).read_text(
        ).splitlines()


def test_pretrain_sim_resume_skips_the_finished_run(sim_runs, capsys):
    root, common = sim_runs
    run_dir = root / "port" / "maven_pretrain" / "run-0"
    before = {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in run_dir.rglob("*")
              if p.is_file()}
    capsys.readouterr()
    pretrain_sim.main([*common, "--cache-dir", str(root / "cache-port"), "--analysis-path",
                       str(root / "port"), "--device", "cpu", "--resume"])
    out = capsys.readouterr().out
    after = {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in run_dir.rglob("*")
             if p.is_file()}
    assert before == after and len(before) >= len(RUN_FILES)
    assert "cache=hit" in out and "epochs=0" in out


def test_pretrain_sim_check_exits_0():
    """--check on the shipped config: every grid point on the meta device,
    no data and no card."""
    with pytest.raises(SystemExit) as exc:
        pretrain_sim.main([str(MAVEN_PRETRAIN), "--check", "--device", "cpu"])
    assert exc.value.code == 0


def test_pretrain_sim_streaming_raises_with_its_item(sim_runs, tmp_path, capsys):
    """Ported (item 17b): --streaming on the mini corpus writes the stream-<key>
    cache beside the in-memory one and trains run-0 from its shards; a shard
    cache written by the JAX package is read (tests/test_torch_streaming.py
    holds the CLI to the JAX CLI)."""
    root, common = sim_runs
    capsys.readouterr()
    pretrain_sim.main([*common, "--cache-dir", str(tmp_path / "cache"), "--analysis-path",
                       str(tmp_path / "runs"), "--device", "cpu", "--streaming",
                       "--rows-per-shard", "9"])
    out = capsys.readouterr().out
    assert "sharded cache written" in out and "epochs=1" in out
    assert [n for n in os.listdir(tmp_path / "cache") if n.startswith("stream-")]
    run = tmp_path / "runs" / "maven_pretrain" / "run-0"
    assert RUN_FILES <= set(os.listdir(run)) and "ckpt_cursor" in os.listdir(run)
