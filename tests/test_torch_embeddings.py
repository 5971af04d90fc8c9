"""``get_embeddings`` of the port against the JAX package's, on CPU: the
same weights (carried across by ``models/convert.py``) and the same
synthetic dataset give the same per-modality embeddings within 2e-5 in
float32, for every sample in the dataset's order, n not a multiple of the
batch; the names come in canonical order; each row equals ``encode`` of a
batch holding that sample."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic_dataset,
)
from multimodal_supernovae_tpu.evaluation.embeddings import (
    get_embeddings as jax_get_embeddings,
)
from multimodal_supernovae_tpu.models import CLIPConfig as JaxCLIPConfig
from multimodal_supernovae_tpu.models import CLIPModel as JaxCLIPModel
from multimodal_supernovae_tpu_torch.data import make_synthetic_dataset
from multimodal_supernovae_tpu_torch.evaluation import get_embeddings
from multimodal_supernovae_tpu_torch.models import CLIPConfig, CLIPModel, state_dict_from_jax

SYN = dict(n_max_lc=10, nband=2, n_max_sp=16)
N = 23  # not a multiple of any batch below


def _cfg_kwargs(combinations):
    lc = {"n_out": 8, "emb": 16, "heads": 2, "depth": 2, "time_norm": 2000.0,
          "agg": "attn", "dropout": 0.1}
    sp = {"n_out": 8, "emb": 16, "heads": 4, "depth": 1, "time_norm": 1800.0,
          "agg": "mean", "dropout": 0.1}
    return dict(combinations=combinations, enc_dim=8, nband=2, loss="softmax",
                transformer_kwargs=lc, transformer_spectral_kwargs=sp)


def _models(combinations, seed=0):
    jmodel = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **_cfg_kwargs(combinations)))
    jds = jax_make_synthetic_dataset(n=N, seed=seed, modalities=list(combinations), **SYN)
    variables = jmodel.init(jax.random.PRNGKey(seed), jds.to_device().take(jnp.arange(4)))
    model = CLIPModel(CLIPConfig.create(**_cfg_kwargs(combinations)))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           state_dict_from_jax(variables["params"]).items()}, strict=True)
    ds = make_synthetic_dataset(n=N, seed=seed, modalities=combinations, **SYN)
    return jmodel, variables, jds, model, ds


@pytest.mark.parametrize("combinations", [
    ("spectral", "lightcurve"), ("lightcurve",), ("spectral",)])
@pytest.mark.parametrize("batch_size", [8, 5, 256])
def test_get_embeddings_matches_jax(combinations, batch_size):
    jmodel, variables, jds, model, ds = _models(combinations)
    want, want_names = jax_get_embeddings(jmodel, variables, jds, batch_size=batch_size)
    got, names = get_embeddings(model, ds, batch_size=batch_size, device="cpu")
    assert names == want_names == [m for m in ("lightcurve", "spectral")
                                   if m in combinations]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (N, 8) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(g, axis=-1), 1.0, atol=1e-5)


def test_rows_are_encode_of_their_samples_in_eval_mode():
    """Every row equals encode (eval mode) of a batch holding its sample,
    dropout off; the model comes back in the mode it was in."""
    _, _, _, model, ds = _models(("lightcurve", "spectral"))
    model.train()
    got, _ = get_embeddings(model, ds, batch_size=6, device="cpu")
    assert model.training
    data = ds.to_device("cpu")
    idx = torch.tensor([22, 0, 7, 7])
    with torch.no_grad():
        want = model.encode({k: v[idx] for k, v in data.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[idx.numpy()], w.numpy(), atol=1e-6, rtol=0)


def test_runs_on_the_card_unless_asked_and_checks_the_device():
    import inspect

    _, _, _, model, ds = _models(("lightcurve",))
    assert inspect.signature(get_embeddings).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_embeddings(model, ds)
    with pytest.raises(ValueError, match="empty"):
        get_embeddings(model, ds.subset(np.arange(0)), device="cpu")
    with pytest.raises(ValueError, match="not on meta"):
        get_embeddings(model, ds, device="meta")
