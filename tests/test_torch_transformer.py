"""The port's sequence encoder against the JAX package's, on CPU, with the
weights of a JAX init carried over by ``seq_encoder_state_dict``.

Tolerances: float32 2e-5 for single ops, 1e-4 for blocks and whole towers
(summation order differs between XLA and torch); bfloat16 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu.models.transformer import (
    SequenceEncoder as JaxSequenceEncoder,
    TransformerBlock as JaxTransformerBlock,
    time_positional_encoding as jax_tpe,
)
from multimodal_supernovae_tpu_torch.models import (
    SequenceEncoder,
    seq_encoder_state_dict,
    time_positional_encoding,
)

EMB, HEADS, DEPTH = 16, 2, 2


def _seq_inputs(seed, b=3, t=24, ragged=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t)).astype(np.float32)
    tt = (rng.random((b, t)) * 100).astype(np.float32)
    mask = np.ones((b, t), bool)
    if ragged:
        for i in range(b):
            mask[i, rng.integers(t // 2, t + 1):] = False
    return x, tt, mask


def _torch_encoder(jparams, dtype=None, **kw):
    enc = SequenceEncoder(dtype=dtype, **kw).eval()
    sd = {k: torch.tensor(v) for k, v in seq_encoder_state_dict(jparams).items()}
    enc.load_state_dict(sd, strict=True)
    return enc


def test_time_positional_encoding_matches_jax():
    t = (np.random.default_rng(0).random((3, 17)) * 1000).astype(np.float32)
    want = np.asarray(jax_tpe(jnp.asarray(t), 16, 20583.37))
    got = time_positional_encoding(torch.from_numpy(t), 16, 20583.37).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("agg,nband", [("mean", 1), ("mean", 2), ("attn", 1),
                                       ("attn", 2), ("max", 1)])
def test_sequence_encoder_matches_jax(agg, nband):
    kw = dict(n_out=8, emb=EMB, heads=HEADS, depth=DEPTH, nband=nband, agg=agg,
              time_norm=1000.0)
    x, t, mask = _seq_inputs(nband + len(agg))
    jenc = JaxSequenceEncoder(use_pallas=False, **kw)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(mask))["params"]
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x),
                                 jnp.asarray(t), jnp.asarray(mask)))
    enc = _torch_encoder(params, **kw)
    with torch.no_grad():
        got = enc(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (3, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("agg", ["mean", "attn"])
def test_sequence_encoder_bf16_matches_jax(agg):
    kw = dict(n_out=8, emb=EMB, heads=HEADS, depth=DEPTH, nband=2, agg=agg,
              time_norm=1000.0)
    x, t, mask = _seq_inputs(11)
    jenc = JaxSequenceEncoder(use_pallas=False, dtype=jnp.bfloat16, **kw)
    params = jenc.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(mask))["params"]
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x),
                                 jnp.asarray(t), jnp.asarray(mask)))
    enc = _torch_encoder(params, dtype=torch.bfloat16, **kw)
    with torch.no_grad():
        got = enc(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mask))
    assert got.dtype == torch.float32  # the projection stays float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_block_matches_jax(dtype):
    kw = dict(n_out=8, emb=EMB, heads=HEADS, depth=1, agg="mean", time_norm=1000.0)
    x, t, mask = _seq_inputs(21)
    jenc = JaxSequenceEncoder(use_pallas=False, **kw)
    params = jenc.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(mask))["params"]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    block = JaxTransformerBlock(EMB, HEADS, use_pallas=False, dtype=jdt)
    h = np.random.default_rng(3).normal(size=(3, 24, EMB)).astype(np.float32)
    want = block.apply({"params": params["transformer"]["block_0"]},
                       jnp.asarray(h), jnp.asarray(mask))
    enc = _torch_encoder(params, dtype=getattr(torch, dtype) if jdt else None, **kw)
    with torch.no_grad():
        got = enc.transformer.tblocks[0](torch.from_numpy(h), torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 0.05
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_layer_norm_matches_flax_at_eps_scale_variance():
    """A variance near eps tells flax's 1e-6 from torch's default 1e-5."""
    from flax import linen as fnn

    from multimodal_supernovae_tpu_torch.models.transformer import LayerNorm

    x = (np.random.default_rng(4).normal(size=(3, 16)) * 1e-3).astype(np.float32)
    want = fnn.LayerNorm().apply({"params": {"scale": jnp.ones(16),
                                             "bias": jnp.zeros(16)}}, jnp.asarray(x))
    got = LayerNorm(16)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    assert not np.allclose(
        torch.nn.functional.layer_norm(torch.from_numpy(x), (16,)).numpy(),
        np.asarray(want), rtol=1e-2, atol=1e-2)
