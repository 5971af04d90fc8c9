"""The port stands alone: importing it (training, serving and the CLI
included) loads no jax, flax or yaml, which the GPU host does not have, and
nothing of the JAX package; no file of the port, nor chip_smoke.py, imports
the JAX package. Its synthetic generator draws the JAX generator's numbers
for the same seed, and its batcher coalesces a feed as the JAX one does."""

import ast
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from multimodal_supernovae_tpu.data.synthetic import make_synthetic_dataset
from multimodal_supernovae_tpu.serving.batcher import DynamicBatcher as JaxBatcher
from multimodal_supernovae_tpu_torch.data import make_synthetic_arrays
from multimodal_supernovae_tpu_torch.serving.batcher import DynamicBatcher

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml",
             "multimodal_supernovae_tpu", "pandas", "PIL", "sklearn", "h5py", "matplotlib",
             "huggingface_hub")


def test_port_imports_no_jax():
    code = (
        "import sys, json\n"
        "import multimodal_supernovae_tpu_torch\n"
        "import multimodal_supernovae_tpu_torch.ops\n"
        "import multimodal_supernovae_tpu_torch.kernels\n"
        "import multimodal_supernovae_tpu_torch.models\n"
        "import multimodal_supernovae_tpu_torch.models.convmixer\n"
        "import multimodal_supernovae_tpu_torch.models.mlp\n"
        "import multimodal_supernovae_tpu_torch.models.pretraining\n"
        "import multimodal_supernovae_tpu_torch.models.clip_mlp\n"
        "import multimodal_supernovae_tpu_torch.data.transforms\n"
        "import multimodal_supernovae_tpu_torch.evaluation\n"
        "import multimodal_supernovae_tpu_torch.data\n"
        "import multimodal_supernovae_tpu_torch.data.augment\n"
        "import multimodal_supernovae_tpu_torch.data.batching\n"
        "import multimodal_supernovae_tpu_torch.ops.flash_attention\n"
        "import multimodal_supernovae_tpu_torch.ops.losses\n"
        "import multimodal_supernovae_tpu_torch.ops.metrics\n"
        "import multimodal_supernovae_tpu_torch.training\n"
        "import multimodal_supernovae_tpu_torch.training.trainer\n"
        "import multimodal_supernovae_tpu_torch.training.experiment\n"
        "import multimodal_supernovae_tpu_torch.ops.fused_block\n"
        "import multimodal_supernovae_tpu_torch.ops.qkv_attention\n"
        "import multimodal_supernovae_tpu_torch.serving\n"
        "import multimodal_supernovae_tpu_torch.serving.batcher\n"
        "import multimodal_supernovae_tpu_torch.serving.server\n"
        "import multimodal_supernovae_tpu_torch.cli.serve\n"
        "import multimodal_supernovae_tpu_torch.cli.common\n"
        "import multimodal_supernovae_tpu_torch.cli.train\n"
        "import multimodal_supernovae_tpu_torch.cli.finetune_clip\n"
        "import multimodal_supernovae_tpu_torch.cli.pretrain_masked\n"
        "import multimodal_supernovae_tpu_torch.cli.pretrain_sim\n"
        "import multimodal_supernovae_tpu_torch.cli.supervise\n"
        "import multimodal_supernovae_tpu_torch.config.config\n"
        "import multimodal_supernovae_tpu_torch.data.cache\n"
        "import multimodal_supernovae_tpu_torch.data.extinction\n"
        "import multimodal_supernovae_tpu_torch.data.folds\n"
        "import multimodal_supernovae_tpu_torch.data.native\n"
        "import multimodal_supernovae_tpu_torch.data.png\n"
        "import multimodal_supernovae_tpu_torch.data.hdf5\n"
        "import multimodal_supernovae_tpu_torch.data.simulation\n"
        "import multimodal_supernovae_tpu_torch.data.ztfbts\n"
        "import multimodal_supernovae_tpu_torch.utils.io\n"
        "import multimodal_supernovae_tpu_torch.utils.seed\n"
        "import multimodal_supernovae_tpu_torch.evaluation.metrics\n"
        "import multimodal_supernovae_tpu_torch.evaluation.probes\n"
        "import multimodal_supernovae_tpu_torch.evaluation.reports\n"
        "import multimodal_supernovae_tpu_torch.cli.evaluate\n"
        "import multimodal_supernovae_tpu_torch.cli.export_embeddings\n"
        "import multimodal_supernovae_tpu_torch.cli.infer\n"
        "import multimodal_supernovae_tpu_torch.training.preflight\n"
        "import multimodal_supernovae_tpu_torch.__main__\n"
        "import multimodal_supernovae_tpu_torch.cli\n"
        "import multimodal_supernovae_tpu_torch.cli.fetch_data\n"
        "import multimodal_supernovae_tpu_torch.parallel\n"
        "import multimodal_supernovae_tpu_torch.parallel.distributed\n"
        "import multimodal_supernovae_tpu_torch.parallel.mesh\n"
        "import multimodal_supernovae_tpu_torch.utils.flops\n"
        "import multimodal_supernovae_tpu_torch.utils.platform\n"
        "import multimodal_supernovae_tpu_torch.utils.profiling\n"
        "import multimodal_supernovae_tpu_torch.utils.draws\n"
        f"print(json.dumps(sorted(m for m in {FORBIDDEN!r} if m in sys.modules)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("seed,modalities", [
    (0, ("lightcurve", "spectral")), (7, ("lightcurve",)), (3, ("spectral",)),
    (1, ("host_galaxy", "lightcurve", "spectral")), (5, ("host_galaxy",)),
    (2, ("host_galaxy", "spectral", "meta"))])
def test_synthetic_matches_jax_generator(seed, modalities):
    kw = dict(n=9, n_max_lc=10, nband=2, n_max_sp=16, modalities=modalities,
              seed=seed)
    if "host_galaxy" in modalities:
        kw["image_size"] = 12 + seed  # images drawn after the spectra
    want = make_synthetic_dataset(**kw).arrays
    got = make_synthetic_arrays(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_synthetic_rejects_unported_modalities():
    """Every modality of the JAX generator is ported (images at the JAX
    default side of 20); an unknown one raises."""
    got = make_synthetic_arrays(n=2, modalities=("host_galaxy",))
    assert got["x_img"].shape == (2, 20, 20, 3) and got["x_img"].dtype == np.float32
    assert 0.0 <= got["x_img"].min() and got["x_img"].max() <= 1.0
    with pytest.raises(ValueError, match="unknown modalities"):
        make_synthetic_arrays(n=2, modalities=("radio",))


def _imported_modules(path):
    """Absolute module names of every import statement in a Python file."""
    names = []
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_no_port_file_imports_the_jax_package():
    files = sorted(Path(REPO, "multimodal_supernovae_tpu_torch").rglob("*.py"))
    files.append(Path(REPO, "chip_smoke.py"))
    assert len(files) > 20
    bad = [(str(f), m) for f in files for m in _imported_modules(f)
           if m == "multimodal_supernovae_tpu" or m.startswith("multimodal_supernovae_tpu.")]
    assert bad == []


def test_entry_points_default_to_the_card():
    """``load_model``, ``load_live``, the evaluation functions, the sweep
    runner and the serving, training and evaluation CLIs run on the card
    unless the caller asks for the CPU; without one they raise."""
    import inspect

    import torch

    from multimodal_supernovae_tpu_torch.evaluation import (
        get_embeddings,
        masked_reconstruction_mse,
        predict_supervised,
    )
    from multimodal_supernovae_tpu_torch.models import load_model
    from multimodal_supernovae_tpu_torch.cli import (
        evaluate,
        export_embeddings,
        finetune_clip,
        infer,
        pretrain_masked,
        pretrain_sim,
        serve,
        train,
    )
    from multimodal_supernovae_tpu_torch.serving import load_live
    from multimodal_supernovae_tpu_torch.training.experiment import run_sweep

    from multimodal_supernovae_tpu_torch.parallel.distributed import initialize, mesh_from_args

    for fn in (load_model, load_live, get_embeddings, predict_supervised,
               masked_reconstruction_mse, run_sweep, initialize, mesh_from_args):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    for cli in (serve, train, finetune_clip, pretrain_masked, pretrain_sim, evaluate,
                export_embeddings, infer):
        assert cli.build_parser().get_default("device") == "cuda", cli
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_model("no-such-run-dir")


def _echo(feed):
    """A fixed-batch fn: row i's outputs are functions of row i alone."""
    x = feed["x"]
    return [x.sum(axis=1, keepdims=True) * 2.0, x[:, :2] + 1.0]


SPEC = {"x": ((3,), "float32")}


def _feeds(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(n, 3)).astype(np.float32)} for n in sizes]


@pytest.mark.parametrize("sizes,batch", [
    ((1, 2, 3), 8),      # coalesced into one device call
    ((11,), 4),          # a request larger than the batch: chunked
    ((3, 5, 4, 1), 4),   # chunks that do not fit start the next batch
])
def test_batcher_matches_jax_batcher(sizes, batch):
    feeds = _feeds(sizes)
    results = {}
    for name, cls in (("jax", JaxBatcher), ("port", DynamicBatcher)):
        b = cls(_echo, SPEC, batch, max_wait_ms=200.0)
        out = [None] * len(feeds)

        def client(i):
            out[i] = b.submit(feeds[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(feeds))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        stats = b.stats.snapshot()
        b.close()
        results[name] = (out, stats)
    (jout, jstats), (pout, pstats) = results["jax"], results["port"]
    for feed, j, p in zip(feeds, jout, pout):
        for jo, po, want in zip(j, p, _echo(feed)):
            np.testing.assert_array_equal(po, jo)
            np.testing.assert_allclose(po, want, rtol=1e-6)
    for key in ("requests", "samples"):
        assert pstats[key] == jstats[key] == (len(sizes) if key == "requests" else sum(sizes))
    assert pstats["device_calls"] >= -(-sum(sizes) // batch)
    assert pstats["device_calls"] * batch - pstats["padded_samples"] == sum(sizes)


def test_batcher_rejects_what_the_jax_batcher_rejects():
    for cls in (JaxBatcher, DynamicBatcher):
        b = cls(_echo, SPEC, 4)
        try:
            for bad in ({"y": np.zeros((2, 3))}, {"x": np.zeros((2, 4))},
                        {"x": np.zeros((0, 3))}):
                with pytest.raises(ValueError):
                    b.submit(bad)
        finally:
            b.close()
