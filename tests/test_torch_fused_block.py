"""The port's fused-block path against the JAX package's, on CPU.

The JAX side runs its Pallas kernels under ``pltpu.force_tpu_interpret_mode()``
as its own tests do; the port runs the plain versions of its CUDA kernels,
which a CPU tensor selects. Weights come from a JAX init. Tolerances: float32
forward 2e-5 and gradients 2e-4 (the JAX fused tests' own), whole models
1e-4 (forward) and 5e-4 (gradients), bfloat16 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multimodal_supernovae_tpu.data.batching import Batch
from multimodal_supernovae_tpu.models import CLIPConfig as JaxCLIPConfig
from multimodal_supernovae_tpu.models import CLIPModel as JaxCLIPModel
from multimodal_supernovae_tpu.models.factory import write_model_config
from multimodal_supernovae_tpu.models.torch_export import export_reference_checkpoint
from multimodal_supernovae_tpu.models.transformer import (
    SequenceEncoder as JaxSequenceEncoder,
    TransformerBlock as JaxTransformerBlock,
)
from multimodal_supernovae_tpu.ops import fused_block as jfb
from multimodal_supernovae_tpu_torch.data import make_synthetic_arrays
from multimodal_supernovae_tpu_torch.models import (
    CLIPConfig,
    CLIPModel,
    SequenceEncoder,
    load_model,
    seq_encoder_state_dict,
    state_dict_from_jax,
)
from multimodal_supernovae_tpu_torch.models import transformer as tm
from multimodal_supernovae_tpu_torch.models.transformer import TransformerBlock
from multimodal_supernovae_tpu_torch.ops import fused_block as fb

B, T, E, H, FM = 4, 24, 16, 2, 4  # as tests/test_fused_block.py
FIELDS = ("x_lc", "t_lc", "mask_lc", "x_sp", "t_sp", "mask_sp")
# flax block params -> the port's TransformerBlock parameter names
_NAMES = {
    ("attention", "toqueries", "kernel"): "attention.toqueries.weight",
    ("attention", "tokeys", "kernel"): "attention.tokeys.weight",
    ("attention", "tovalues", "kernel"): "attention.tovalues.weight",
    ("attention", "unifyheads", "kernel"): "attention.unifyheads.weight",
    ("attention", "unifyheads", "bias"): "attention.unifyheads.bias",
    ("norm1", "scale"): "norm1.weight", ("norm1", "bias"): "norm1.bias",
    ("ff_in", "kernel"): "ff.0.weight", ("ff_in", "bias"): "ff.0.bias",
    ("ff_out", "kernel"): "ff.2.weight", ("ff_out", "bias"): "ff.2.bias",
    ("norm2", "scale"): "norm2.weight", ("norm2", "bias"): "norm2.bias",
}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float32)


def _block_sd(p):
    """flax TransformerBlock params -> port state_dict (kernels transposed)."""
    return {name: torch.tensor(_get(p, path).T.copy() if path[-1] == "kernel"
                               else _get(p, path))
            for path, name in _NAMES.items()}


def _jax_params_dict(p):
    a = p["attention"]
    return {
        "toqueries": a["toqueries"]["kernel"], "tokeys": a["tokeys"]["kernel"],
        "tovalues": a["tovalues"]["kernel"],
        "unifyheads_kernel": a["unifyheads"]["kernel"],
        "unifyheads_bias": a["unifyheads"]["bias"],
        "norm1_scale": p["norm1"]["scale"], "norm1_bias": p["norm1"]["bias"],
        "ff_in_kernel": p["ff_in"]["kernel"], "ff_in_bias": p["ff_in"]["bias"],
        "ff_out_kernel": p["ff_out"]["kernel"], "ff_out_bias": p["ff_out"]["bias"],
        "norm2_scale": p["norm2"]["scale"], "norm2_bias": p["norm2"]["bias"],
    }


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, E)).astype(np.float32)
    mask = rng.random((B, T)) > 0.3
    mask[0] = False  # one fully masked sample
    block = JaxTransformerBlock(emb=E, heads=H, ff_hidden_mult=FM, use_pallas=False)
    params = block.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))["params"]
    params = jax.tree_util.tree_map(  # non-trivial norm/bias parameters
        lambda v: v + jnp.asarray(rng.normal(size=v.shape), v.dtype) * 0.05, params)
    cot = rng.normal(size=(B, T, E)).astype(np.float32)
    return params, x, mask, cot


def _port_block(params, **kw):
    blk = TransformerBlock(E, H, FM, **kw)
    blk.load_state_dict(_block_sd(params), strict=True)
    return blk


def _ffn_args(params, x, rng):
    """(att, x) rows and the ten parameters, in flax (JAX) and port layouts."""
    att = rng.normal(size=(B * T, E)).astype(np.float32)
    xr = x.reshape(B * T, E)
    jw = [_get(params, p) for p in (
        ("attention", "unifyheads", "kernel"), ("attention", "unifyheads", "bias"),
        ("norm1", "scale"), ("norm1", "bias"), ("ff_in", "kernel"), ("ff_in", "bias"),
        ("ff_out", "kernel"), ("ff_out", "bias"), ("norm2", "scale"), ("norm2", "bias"))]
    tw = [w.T.copy() if w.ndim == 2 else w for w in jw]
    return att, xr, jw, tw


def test_fused_ffn_block_matches_jax(setup):
    params, x, _, cot = setup
    att, xr, jw, tw = _ffn_args(params, x, np.random.default_rng(1))
    g = cot.reshape(B * T, E)
    jargs = [jnp.asarray(att), jnp.asarray(xr)] + [
        jnp.asarray(w if w.ndim == 2 else w[None]) for w in jw]
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda *a: jfb.fused_ffn_block(*a), *jargs)
        jgrads = vjp(jnp.asarray(g))
    targs = [torch.tensor(a, requires_grad=True) for a in [att, xr] + tw]
    got = fb.fused_ffn_block(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    got.backward(torch.from_numpy(g))
    for i, (t, w) in enumerate(zip(targs, jgrads)):
        w = np.asarray(w)
        w = w.T if t.dim() == 2 and i >= 2 else w.reshape(t.shape)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=2e-4, atol=2e-4,
                                   err_msg=f"input {i}")


def test_plain_backward_equals_autograd_of_plain_forward(setup):
    """The explicit plain backward (the kernel's recipe) against torch
    autograd through the plain forward, float32."""
    params, x, _, cot = setup
    att, xr, _, tw = _ffn_args(params, x, np.random.default_rng(2))
    targs = [torch.tensor(a, requires_grad=True) for a in [att, xr] + tw]
    fb.fused_ffn_block_plain(*targs).backward(torch.from_numpy(cot.reshape(B * T, E)))
    got = fb.fused_ffn_block_bwd_plain(*[t.detach() for t in targs],
                                       torch.from_numpy(cot.reshape(B * T, E)))
    for i, (t, gi) in enumerate(zip(targs, got)):
        np.testing.assert_allclose(gi.numpy(), t.grad.numpy(), rtol=2e-5, atol=2e-5,
                                   err_msg=f"input {i}")


@pytest.mark.parametrize("masked", [True, False])
def test_fused_transformer_block_matches_jax(setup, masked):
    params, x, mask, cot = setup
    m = mask if masked else None
    jm = None if m is None else jnp.asarray(m)

    def jloss(p, xx):
        out = jfb.fused_transformer_block(xx, jm, _jax_params_dict(p), H)
        return (out * jnp.asarray(cot)).sum(), out

    with pltpu.force_tpu_interpret_mode():
        (_, want), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x))
    blk = _port_block(params)  # E = 16: called directly, below supports()' E >= 64
    xt = torch.tensor(x, requires_grad=True)
    got = tm.fused_transformer_block(xt, None if m is None else torch.from_numpy(m), blk)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=2e-4, atol=2e-4)
    want_sd = _block_sd(jax.tree_util.tree_map(np.asarray, jgp))
    grads = {n: p.grad for n, p in blk.named_parameters()}
    assert sorted(grads) == sorted(want_sd) and len(grads) == 13
    for name, w in want_sd.items():
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_fused_transformer_block_bf16_matches_jax(setup):
    params, x, mask, _ = setup
    with pltpu.force_tpu_interpret_mode():
        want = jfb.fused_transformer_block(jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask),
                                           _jax_params_dict(params), H)
    blk = _port_block(params)
    with torch.no_grad():
        got = tm.fused_transformer_block(torch.from_numpy(x).bfloat16(),
                                         torch.from_numpy(mask), blk)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)


def test_supports_matches_jax_outside_vmem():
    for args in [(64, 8), (32, 2), (60, 6), (64, 2), (128, 8), (16, 2)]:
        assert fb.supports(*args) == jfb.supports(*args), args
    assert fb.supports(64, 8) and not fb.supports(32, 2) and not fb.supports(60, 6)
    # the CUDA kernels' own limit: the backward's row buffers in shared memory
    assert fb.supports(160, 4) and not fb.supports(192, 8)
    assert not fb.supports(64, 8, ff_hidden_mult=24)


def test_routing_rules(monkeypatch):
    """Mirrors the JAX test_use_pallas_does_not_select_fused_block: explicit
    flag, env opt-in (CUDA only), kill switch, configured dropout."""
    calls = []
    real = tm.fused_transformer_block

    def spy(*a, **k):
        calls.append(a[0].dtype)
        return real(*a, **k)

    monkeypatch.setattr(tm, "fused_transformer_block", spy)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 8, 64)).astype(np.float32))
    monkeypatch.delenv("MMSN_FUSED_BLOCK", raising=False)
    TransformerBlock(64, 2)(x)
    assert calls == []                                  # default: unfused
    TransformerBlock(64, 2, use_fused_block=True)(x)
    assert len(calls) == 1                              # explicit True: fused on CPU
    monkeypatch.setenv("MMSN_FUSED_BLOCK", "1")
    blk = TransformerBlock(64, 2)
    blk(x)
    assert len(calls) == 1                              # env opt-in: CPU stays unfused
    assert blk.fused(torch.empty((1, 1, 64), device="meta")) is False
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    assert blk.fused(x)                                 # ... a CUDA tensor engages it
    monkeypatch.undo()
    monkeypatch.setattr(tm, "fused_transformer_block", spy)
    monkeypatch.setenv("MMSN_FUSED_BLOCK", "0")
    TransformerBlock(64, 2, use_fused_block=True)(x)
    assert len(calls) == 1                              # kill switch wins
    monkeypatch.delenv("MMSN_FUSED_BLOCK")
    TransformerBlock(64, 2, dropout=2.2e-4, use_fused_block=True)(x)
    TransformerBlock(32, 2, use_fused_block=True)(x[..., :32])
    assert len(calls) == 1                              # dropout > 0, or E < 64


def _enc_inputs(seed, b=3, t=48):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t)).astype(np.float32)
    tt = (rng.random((b, t)) * 100).astype(np.float32)
    mask = rng.random((b, t)) > 0.2
    return x, tt, mask


def test_sequence_encoder_bf16_fused_blocks_compute_in_float32(monkeypatch):
    """Under a bf16 policy the band embedding promotes the LC tower's
    activations to float32, so the JAX fused blocks compute in float32; a
    port that cast them to bf16 would miss the 1e-3 tolerance."""
    kw = dict(n_out=4, emb=64, heads=8, depth=2, nband=2, agg="attn", time_norm=1000.0)
    x, t, mask = _enc_inputs(2)
    jenc = JaxSequenceEncoder(use_pallas=False, use_fused_block=True,
                              dtype=jnp.bfloat16, **kw)
    with pltpu.force_tpu_interpret_mode():
        params = jenc.init(jax.random.PRNGKey(0), x, t, mask)["params"]
        want = np.asarray(jenc.apply({"params": params}, x, t, mask))
    seen = []
    real = tm.fused_transformer_block
    monkeypatch.setattr(tm, "fused_transformer_block",
                        lambda xx, *a: seen.append(xx.dtype) or real(xx, *a))
    enc = SequenceEncoder(dtype=torch.bfloat16, use_fused_block=True, **kw).eval()
    enc.load_state_dict({k: torch.tensor(v) for k, v in
                         seq_encoder_state_dict(params).items()}, strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mask))
    assert seen == [torch.float32, torch.float32]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def _clip_kwargs():
    lc = {"n_out": 8, "emb": 64, "heads": 8, "depth": 2, "time_norm": 2000.0,
          "agg": "attn", "dropout": 0.0, "use_fused_block": True}
    sp = {"n_out": 8, "emb": 16, "heads": 2, "depth": 2, "time_norm": 1800.0,
          "agg": "mean", "dropout": 0.0, "use_fused_block": True}
    return dict(combinations=("lightcurve", "spectral"), enc_dim=8, nband=2,
                logit_scale_init=19.55, loss="softmax", transformer_kwargs=lc,
                transformer_spectral_kwargs=sp)


def _feed(n=6, seed=0):
    a = make_synthetic_arrays(n=n, n_max_lc=12, nband=2, n_max_sp=20, seed=seed)
    return {k: a[k] for k in FIELDS}


@pytest.fixture(scope="module")
def jax_clip():
    model = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **_clip_kwargs()))
    batch = Batch(**{k: jnp.asarray(v) for k, v in _feed().items()})
    with pltpu.force_tpu_interpret_mode():
        params = model.init(jax.random.PRNGKey(0), batch)["params"]
    return model, params


def test_clip_loss_and_grads_match_jax_under_use_fused_block(jax_clip):
    jmodel, params = jax_clip
    feed = _feed(seed=1)
    jbatch = Batch(**{k: jnp.asarray(v) for k, v in feed.items()})
    with pltpu.force_tpu_interpret_mode():
        (want, _), jgrads = jax.value_and_grad(
            lambda p: jmodel.apply({"params": p}, jbatch, train=True,
                                   method=jmodel.loss_fn), has_aux=True)(params)
    model = CLIPModel(CLIPConfig.create(**_clip_kwargs()))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           state_dict_from_jax(params).items()}, strict=True)
    blocks = model.lightcurve_encoder.transformer.tblocks
    assert all(b.fused(torch.zeros(1)) for b in blocks)
    assert not any(b.fused(torch.zeros(1))
                   for b in model.spectral_encoder.transformer.tblocks)
    got, _ = model.loss_fn({k: torch.from_numpy(v) for k, v in feed.items()},
                           train=True, generator=torch.Generator())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-4)
    want_grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got_grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got_grads) == sorted(want_grads)
    for name, w in want_grads.items():
        np.testing.assert_allclose(got_grads[name].numpy(), w, rtol=5e-4, atol=5e-4,
                                   err_msg=name)


def test_run_dir_with_use_fused_block_loads(jax_clip, tmp_path):
    jmodel, params = jax_clip
    assert write_model_config(str(tmp_path), jmodel)
    export_reference_checkpoint(params, str(tmp_path / "epoch=0-step=0.ckpt"))
    model, _ = load_model(str(tmp_path), "cpu")
    assert dict(model.cfg.transformer_kwargs)["use_fused_block"] is True
    assert model.lightcurve_encoder.transformer.tblocks[0].use_fused_block is True
    feed = _feed(seed=2)
    with pltpu.force_tpu_interpret_mode():
        want = jmodel.apply({"params": params},
                            Batch(**{k: jnp.asarray(v) for k, v in feed.items()}),
                            method=jmodel.encode)
    with torch.inference_mode():
        got = model.encode({k: torch.from_numpy(v) for k, v in feed.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
