"""Fetch and validate the ZTF BTS + simulation corpora (port of
multimodal_supernovae_tpu/cli/fetch_data.py).

One command reproducing the reference's manual data-setup step
(its README's ``git clone
https://huggingface.co/datasets/thelfer/multimodal_supernovae`` plus a
``wget`` of ``sim_data/ZTF_Pretrain_5Class.hdf5``), with two additions the
manual recipe lacks:

* resumable, subset-selectable transfer (``--subset ztfbts|spectra|sim|all``)
  via huggingface_hub's snapshot_download, or from any local mirror
  directory (``--source /path/to/mirror``) for air-gapped hosts;
* a layout validator (``--verify-only``) that checks an existing tree
  against the exact contract the ingest layer reads
  (data/ztfbts.py:5-10, data/simulation.py) so a partial copy fails fast
  here instead of deep inside training.

Expected layout under DEST (identical to the reference's, README.md:76):

  DEST/ZTFBTS/ZTFBTS_TransientTable.csv
  DEST/ZTFBTS/light-curves/<ZTFID>.csv
  DEST/ZTFBTS/hostImgs/<ZTFID>.host.png
  DEST/ZTFBTS_spectra/<ZTFID>.csv
  DEST/sim_data/ZTF_Pretrain_5Class.hdf5

The simulation files are opened with the port's own HDF5 reader
(``data/hdf5.py``; the GPU host has no h5py), and a file it cannot read is
reported as unreadable, as the JAX validator reports what h5py cannot open.
``huggingface_hub`` is imported only for a hub fetch; without it, or
without a network, the command prints the manual recipe and returns 2.

Usage:
  python -m multimodal_supernovae_tpu_torch fetch-data DEST [--subset all] [--source MIRROR]
  python -m multimodal_supernovae_tpu_torch fetch-data DEST --verify-only
"""

from __future__ import annotations

import argparse
import fnmatch
import os
import shutil
import sys

REPO_ID = "thelfer/multimodal_supernovae"
SIM_FILE = "ZTF_Pretrain_5Class.hdf5"

# Subset -> glob patterns over paths inside the dataset repo / mirror.
SUBSETS = {
    "ztfbts": ["ZTFBTS/*"],
    "spectra": ["ZTFBTS_spectra/*"],
    "sim": [f"sim_data/{SIM_FILE}"],
    "all-sims": ["sim_data/*"],
}
SUBSETS["all"] = SUBSETS["ztfbts"] + SUBSETS["spectra"] + SUBSETS["sim"]

MANUAL_RECIPE = f"""\
Network fetch failed. Manual recipe (same sources, reference README):
  git clone https://huggingface.co/datasets/{REPO_ID}
  mv multimodal_supernovae/ZTFBTS* DEST/
  mkdir -p DEST/sim_data && cd DEST/sim_data
  wget https://huggingface.co/datasets/{REPO_ID}/resolve/main/sim_data/{SIM_FILE}
Then validate: python -m multimodal_supernovae_tpu_torch fetch-data DEST --verify-only"""


def _match(rel: str, patterns: list[str]) -> bool:
    return any(
        fnmatch.fnmatch(rel, p) or rel.startswith(p.rstrip("*"))
        for p in patterns
    )


def fetch_local(source: str, dest: str, patterns: list[str]) -> int:
    """Copy the selected subset from a local mirror tree. Skips files that
    already exist with the same size (cheap resume)."""
    n = 0
    for root, _, files in os.walk(source):
        for fname in files:
            src = os.path.join(root, fname)
            rel = os.path.relpath(src, source)
            if not _match(rel, patterns):
                continue
            out = os.path.join(dest, rel)
            if (os.path.exists(out)
                    and os.path.getsize(out) == os.path.getsize(src)):
                continue
            os.makedirs(os.path.dirname(out), exist_ok=True)
            shutil.copy2(src, out)
            n += 1
    return n


def fetch_hub(dest: str, patterns: list[str], repo_id: str = REPO_ID) -> None:
    """Resumable snapshot download of the selected subset from the Hub."""
    from huggingface_hub import snapshot_download

    snapshot_download(
        repo_id=repo_id,
        repo_type="dataset",
        local_dir=dest,
        allow_patterns=patterns,
    )


def verify(dest: str, subset: str = "all") -> list[str]:
    """Validate DEST against the ingest contract; return problem strings."""
    problems: list[str] = []
    want = subset in ("all",)

    if want or subset == "ztfbts":
        table = os.path.join(dest, "ZTFBTS", "ZTFBTS_TransientTable.csv")
        if not os.path.isfile(table):
            problems.append(f"missing {table}")
        else:
            with open(table) as f:
                header = f.readline()
            for col in ("ZTFID", "redshift", "type"):
                if col not in header:
                    problems.append(
                        f"{table}: header lacks required column {col!r}")
        for sub, ext in (("light-curves", ".csv"), ("hostImgs", ".png")):
            d = os.path.join(dest, "ZTFBTS", sub)
            n = (len([f for f in os.listdir(d) if f.endswith(ext)])
                 if os.path.isdir(d) else 0)
            if n == 0:
                problems.append(f"no {ext} files under {d}")

    if want or subset == "spectra":
        d = os.path.join(dest, "ZTFBTS_spectra")
        n = (len([f for f in os.listdir(d) if f.endswith(".csv")])
             if os.path.isdir(d) else 0)
        if n == 0:
            problems.append(f"no spectra csvs under {d}")

    if want or subset in ("sim", "all-sims"):
        d = os.path.join(dest, "sim_data")
        h5s = ([f for f in os.listdir(d) if f.endswith(".hdf5")]
               if os.path.isdir(d) else [])
        if not h5s:
            problems.append(f"no .hdf5 files under {d}")
        else:
            from ..data.hdf5 import File, UnsupportedHDF5

            for fname in h5s:
                path = os.path.join(d, fname)
                try:
                    with File(path) as f:
                        # the sim ingest walks Photometry/<type>/<model>
                        # groups holding these datasets (data/simulation.py)
                        if "Photometry" not in f:
                            problems.append(f"{path}: no Photometry group")
                            continue
                        t_type = next(iter(f["Photometry"]))
                        model = next(iter(f["Photometry"][t_type]))
                        g = f["Photometry"][t_type][model]
                        missing = ({"TID", "z", "mjd", "filter", "mag_obs"}
                                   - set(g.keys()))
                        if missing:
                            problems.append(
                                f"{path}: Photometry/{t_type}/{model} "
                                f"missing datasets {sorted(missing)}")
                except (OSError, UnsupportedHDF5) as e:
                    problems.append(f"{path}: unreadable hdf5 ({e})")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dest", help="target data directory")
    ap.add_argument("--subset", default="all", choices=sorted(SUBSETS))
    ap.add_argument("--source", default=None,
                    help="local mirror directory (offline fetch)")
    ap.add_argument("--repo-id", default=REPO_ID)
    ap.add_argument("--verify-only", action="store_true",
                    help="only validate an existing tree; no transfer")
    args = ap.parse_args(argv)

    patterns = SUBSETS[args.subset]
    if not args.verify_only:
        os.makedirs(args.dest, exist_ok=True)
        if args.source:
            n = fetch_local(args.source, args.dest, patterns)
            print(f"copied {n} new file(s) from {args.source}")
        else:
            try:
                fetch_hub(args.dest, patterns, args.repo_id)
            except Exception as e:  # no egress / auth / transient
                print(f"{type(e).__name__}: {e}", file=sys.stderr)
                print(MANUAL_RECIPE.replace("DEST", args.dest),
                      file=sys.stderr)
                return 2

    problems = verify(args.dest, args.subset)
    for p in problems:
        print("PROBLEM:", p, file=sys.stderr)
    print(f"verify {'FAILED' if problems else 'OK'} "
          f"({args.subset}) at {args.dest}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
