"""The port stands without jax: importing it (training, serving and the CLI
included) loads no jax, flax or yaml, which the GPU host does not have. And its
synthetic generator draws the JAX generator's numbers for the same seed."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from multimodal_supernovae_tpu.data.synthetic import make_synthetic_dataset
from multimodal_supernovae_tpu_torch.data import make_synthetic_arrays

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml")


def test_port_imports_no_jax():
    code = (
        "import sys, json\n"
        "import multimodal_supernovae_tpu_torch\n"
        "import multimodal_supernovae_tpu_torch.ops\n"
        "import multimodal_supernovae_tpu_torch.kernels\n"
        "import multimodal_supernovae_tpu_torch.models\n"
        "import multimodal_supernovae_tpu_torch.data\n"
        "import multimodal_supernovae_tpu_torch.data.augment\n"
        "import multimodal_supernovae_tpu_torch.data.batching\n"
        "import multimodal_supernovae_tpu_torch.ops.flash_attention\n"
        "import multimodal_supernovae_tpu_torch.ops.losses\n"
        "import multimodal_supernovae_tpu_torch.ops.metrics\n"
        "import multimodal_supernovae_tpu_torch.training\n"
        "import multimodal_supernovae_tpu_torch.training.trainer\n"
        "import multimodal_supernovae_tpu_torch.serving\n"
        "import multimodal_supernovae_tpu_torch.cli.serve\n"
        f"print(json.dumps(sorted(m for m in {FORBIDDEN!r} if m in sys.modules)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("seed,modalities", [
    (0, ("lightcurve", "spectral")), (7, ("lightcurve",)), (3, ("spectral",))])
def test_synthetic_matches_jax_generator(seed, modalities):
    kw = dict(n=9, n_max_lc=10, nband=2, n_max_sp=16, modalities=modalities,
              seed=seed)
    want = make_synthetic_dataset(**kw).arrays
    got = make_synthetic_arrays(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_synthetic_rejects_unported_modalities():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_synthetic_arrays(n=2, modalities=("host_galaxy",))
