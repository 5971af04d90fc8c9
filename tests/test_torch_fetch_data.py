"""The port's cli/fetch_data.py against the JAX package's on the CPU: the
validator's problem list on a good tree and on each broken one (the
simulation files written with h5py, read by the port's own HDF5 reader),
the local-mirror copy, and the hub path without huggingface_hub (it
prints the manual recipe and returns 2; nothing reaches the network)."""

import os
import shutil
import sys

import pytest

from fixtures import write_mini_sim_hdf5, write_mini_ztfbts
from multimodal_supernovae_tpu.cli import fetch_data as jax_fetch_data
from multimodal_supernovae_tpu_torch.cli import fetch_data

SIM = "ZTF_Pretrain_5Class.hdf5"


@pytest.fixture()
def mirror(tmp_path):
    src = tmp_path / "mirror"
    write_mini_ztfbts(str(src), n=6)
    os.makedirs(src / "sim_data", exist_ok=True)
    write_mini_sim_hdf5(str(src / "sim_data" / SIM), n_per_type=4)
    return src


def _no_table(root):
    os.remove(root / "ZTFBTS" / "ZTFBTS_TransientTable.csv")


def _missing_column(root):
    table = root / "ZTFBTS" / "ZTFBTS_TransientTable.csv"
    lines = table.read_text().splitlines()
    table.write_text("\n".join([lines[0].replace("redshift", "z_host")] + lines[1:]) + "\n")


def _no_pngs(root):
    shutil.rmtree(root / "ZTFBTS" / "hostImgs")


def _no_spectra(root):
    for f in os.listdir(root / "ZTFBTS_spectra"):
        os.remove(root / "ZTFBTS_spectra" / f)


def _no_hdf5(root):
    os.remove(root / "sim_data" / SIM)


def _missing_dataset(root):
    import h5py

    os.remove(root / "sim_data" / SIM)
    with h5py.File(root / "sim_data" / "bad.hdf5", "w") as f:
        g = f.create_group("Photometry/Ia/model0")
        g["TID"] = [1, 2]
        g["z"] = [0.1, 0.2]


def _no_photometry(root):
    import h5py

    with h5py.File(root / "sim_data" / "spectra_only.hdf5", "w") as f:
        f.create_group("Spectroscopy/Ia/model0")["TID"] = [1]


def _unreadable(root):
    (root / "sim_data" / "broken.hdf5").write_bytes(b"not an hdf5 file at all" * 10)


BROKEN = [_no_table, _missing_column, _no_pngs, _no_spectra, _no_hdf5, _missing_dataset,
          _no_photometry, _unreadable]


@pytest.mark.parametrize("subset", ["all", "ztfbts", "spectra", "sim"])
def test_verify_is_clean_on_a_good_tree(mirror, subset):
    assert fetch_data.verify(str(mirror), subset) == jax_fetch_data.verify(str(mirror), subset) == []


@pytest.mark.parametrize("breaker", BROKEN, ids=lambda f: f.__name__.strip("_"))
def test_verify_gives_the_jax_problem_list(mirror, breaker):
    breaker(mirror)
    got, want = fetch_data.verify(str(mirror)), jax_fetch_data.verify(str(mirror))
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        if "unreadable hdf5 (" in w:  # the reader's own words in the parentheses
            assert g.split(" (")[0] == w.split(" (")[0]
        else:
            assert g == w


def _tree(root):
    return sorted((os.path.relpath(os.path.join(d, f), root), os.path.getsize(os.path.join(d, f)))
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("subset", ["all", "ztfbts", "sim"])
def test_fetch_local_copies_what_the_jax_fetch_copies(mirror, tmp_path, subset):
    pats = fetch_data.SUBSETS[subset]
    assert pats == jax_fetch_data.SUBSETS[subset]
    n = fetch_data.fetch_local(str(mirror), str(tmp_path / "port"), pats)
    assert n == jax_fetch_data.fetch_local(str(mirror), str(tmp_path / "jax"), pats) > 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert fetch_data.fetch_local(str(mirror), str(tmp_path / "port"), pats) == 0  # resumable


def test_main_local_fetch_then_verify_only(mirror, tmp_path, capsys):
    dest = str(tmp_path / "data")
    assert fetch_data.main([dest, "--source", str(mirror)]) == 0
    assert fetch_data.main([dest, "--verify-only"]) == 0
    assert "verify OK (all)" in capsys.readouterr().out
    os.remove(os.path.join(dest, "sim_data", SIM))
    assert fetch_data.main([dest, "--verify-only"]) == 1


def test_hub_fetch_without_huggingface_hub_prints_the_recipe(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # the import fails
    dest = str(tmp_path / "data")
    assert fetch_data.main([dest]) == 2
    err = capsys.readouterr().err
    assert "Manual recipe" in err and f"mv multimodal_supernovae/ZTFBTS* {dest}/" in err
    assert fetch_data.MANUAL_RECIPE.splitlines()[1:3] == \
        jax_fetch_data.MANUAL_RECIPE.splitlines()[1:3]
