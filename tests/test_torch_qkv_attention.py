"""The port's fused-QKV path against the JAX package's, on CPU.

The JAX side runs its Pallas kernels under ``pltpu.force_tpu_interpret_mode()``;
the port runs the plain versions of its CUDA kernels, which a CPU tensor
selects. Inputs come from a numpy seed. Tolerances: float32 forward 2e-5,
float32 gradients 5e-4 of each one's largest (the JAX kernel tests' gradient
tolerance), bfloat16 0.05; whole models 1e-4 relative on the loss and 5e-4 on
gradients. The JAX kernel pads T to a multiple of 8 and a fully masked sample
then averages over the padded keys too, where the port (as ``dense_attention``)
averages over the T keys: such a sample appears only at T a multiple of 8.
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
from multimodal_supernovae_tpu.ops import qkv_attention as jqa
from multimodal_supernovae_tpu_torch.data import make_synthetic_arrays
from multimodal_supernovae_tpu_torch.models import CLIPConfig, CLIPModel, state_dict_from_jax
from multimodal_supernovae_tpu_torch.models import transformer as tm
from multimodal_supernovae_tpu_torch.models.transformer import (
    SelfAttention,
    SequenceEncoder,
    init_weights,
)
from multimodal_supernovae_tpu_torch.ops import qkv_attention as qa

FIELDS = ("x_lc", "t_lc", "mask_lc", "x_sp", "t_sp", "mask_sp")
GRAD_NAMES = ("x", "wq", "wk", "wv", "wu", "bu")


def _inputs(seed, b, t, e, mask):
    """x, mask, flax-layout (in, out) weights wq, wk, wv, wu, bias, cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, e)).astype(np.float32)
    ws = [(rng.normal(size=(e, e)) * e ** -0.5).astype(np.float32) for _ in range(4)]
    bu = (rng.normal(size=(e,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(b, t, e)).astype(np.float32)
    if mask == "none":
        m = None
    else:
        m = rng.random((b, t)) > 0.3
        m[:, 0] = True
        if mask == "masked_sample":
            m[0] = False
    return x, m, ws, bu, g


def _port_args(x, m, ws, bu, dtype=torch.float32):
    """The port's arguments: weights transposed to (out, in)."""
    return (torch.from_numpy(x).to(dtype), None if m is None else torch.from_numpy(m),
            *(torch.from_numpy(w.T.copy()) for w in ws), torch.from_numpy(bu))


CASES = [  # (B, T, E, heads), mask
    ((3, 16, 32, 2), "masked_sample"), ((3, 40, 32, 2), "masked_sample"),
    ((3, 37, 32, 2), "ragged"), ((3, 24, 32, 2), "none"),
    ((3, 16, 64, 8), "masked_sample"), ((3, 40, 64, 8), "masked_sample"),
    ((3, 37, 64, 8), "ragged"), ((3, 24, 64, 8), "none"),
]


def _both(shape, mask, seed, dtype):
    """Output and gradients of (x, wq, wk, wv, wu, bu) from the JAX kernels in
    interpret mode and from the port's entry on the CPU, as float32 numpy
    arrays in the port's (out, in) weight layout."""
    b, t, e, h = shape
    x, m, ws, bu, g = _inputs(seed, b, t, e, mask)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jm = None if m is None else jnp.asarray(m)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(
            lambda xx, wq, wk, wv, wu, bb: jqa.fused_qkv_attention(
                xx, jm, wq, wk, wv, wu, bb, heads=h, emb=e),
            jnp.asarray(x, jdt), *(jnp.asarray(w) for w in ws), jnp.asarray(bu))
        jgrads = [np.asarray(w, np.float32) for w in vjp(jnp.asarray(g, jdt))]
    jgrads = [w.T if name.startswith("w") else w for name, w in zip(GRAD_NAMES, jgrads)]
    tx, tmask, *params = _port_args(x, m, ws, bu, dtype)
    leaves = [a.requires_grad_() for a in (tx, *params)]
    got = qa.fused_qkv_attention(leaves[0], tmask, *leaves[1:], heads=h, emb=e)
    got.backward(torch.from_numpy(g).to(dtype))
    assert got.dtype == dtype
    assert all(leaf.grad.dtype == leaf.dtype for leaf in leaves)  # weights' stay float32
    return (got.detach().float().numpy(), [leaf.grad.float().numpy() for leaf in leaves],
            np.asarray(want, np.float32), jgrads)


@pytest.mark.parametrize("shape,mask", CASES)
def test_forward_and_gradients_match_jax_kernels(shape, mask):
    got, grads, want, jgrads = _both(shape, mask, shape[1] + shape[2], torch.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for name, a, w in zip(GRAD_NAMES, grads, jgrads):
        assert np.abs(a - w).max() <= 5e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("shape,mask", [((3, 40, 32, 2), "masked_sample"),
                                        ((3, 37, 64, 8), "ragged")])
def test_bfloat16_matches_jax_kernels(shape, mask):
    got, grads, want, jgrads = _both(shape, mask, shape[1] + shape[2] + 1, torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
    for name, a, w in zip(GRAD_NAMES, grads, jgrads):
        assert np.abs(a - w).max() <= 0.05 * np.abs(w).max(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,mask", [((3, 21, 32, 2), "masked_sample"),
                                        ((2, 40, 64, 8), "ragged"),
                                        ((2, 16, 64, 8), "none")])
def test_plain_backward_equals_autograd_of_plain_forward(shape, mask, dtype):
    """The explicit plain backward (the kernel's recipe) against torch
    autograd through the plain forward. In bfloat16 autograd passes the
    roundings straight through where the recipe rounds its intermediates."""
    b, t, e, h = shape
    x, m, ws, bu, g = _inputs(7, b, t, e, mask)
    tx, tmask, wq, wk, wv, wu, tbu = _port_args(x, m, ws, bu, dtype)
    wqkv = torch.cat([wq * e ** -0.25, wk * e ** -0.25, wv])
    tg = torch.from_numpy(g).to(dtype)
    leaves = [a.clone().requires_grad_() for a in (tx, wqkv, wu, tbu)]
    qa.fused_qkv_attention_plain(leaves[0], tmask, *leaves[1:], h).backward(tg)
    got = qa.fused_qkv_attention_bwd_plain(tx, tmask, wqkv, wu, tg, h)
    tol = 2e-5 if dtype == torch.float32 else 0.05
    for name, a, leaf in zip(("dx", "dwqkv", "dwu", "dbu"), got, leaves):
        assert a.dtype == leaf.dtype and a.shape == leaf.shape, name
        w = leaf.grad.float()
        assert float((a.float() - w).abs().max()) <= tol * float(w.abs().max()), name


@pytest.mark.parametrize("shape,mask", [((3, 37, 32, 2), "masked_sample"),
                                        ((2, 40, 64, 8), "ragged"),
                                        ((2, 24, 64, 8), "none")])
def test_fused_route_matches_unfused_self_attention(shape, mask):
    """The plain fused route against the port's unfused ``SelfAttention`` on
    the same weights, float32: output and every gradient."""
    b, t, e, h = shape
    x, m, _, _, g = _inputs(9, b, t, e, mask)
    sa = SelfAttention(e, h)
    init_weights(sa, torch.Generator().manual_seed(0))
    with torch.no_grad():
        sa.unifyheads.bias.normal_(generator=torch.Generator().manual_seed(1)).mul_(0.1)
    tmask = None if m is None else torch.from_numpy(m)
    x1 = torch.from_numpy(x).requires_grad_()
    want = sa(x1, tmask)
    want.backward(torch.from_numpy(g))
    want_grads = [x1.grad] + [p.grad.clone() for p in sa.parameters()]
    sa.zero_grad()
    x2 = torch.from_numpy(x).requires_grad_()
    got = qa.fused_qkv_attention(x2, tmask, sa.toqueries.weight, sa.tokeys.weight,
                                 sa.tovalues.weight, sa.unifyheads.weight,
                                 sa.unifyheads.bias, heads=h, emb=e)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    got.backward(torch.from_numpy(g))
    got_grads = [x2.grad] + [p.grad for p in sa.parameters()]
    for a, w in zip(got_grads, want_grads):
        assert float((a - w).abs().max()) <= 5e-4 * float(w.abs().max())


def test_supports_matches_jax_within_the_kernels_limits():
    grid = [(t, e, h) for t in (1, 8, 37, 200, 220, 249, 256, 257, 264, 1024)
            for e, h in ((32, 2), (32, 4), (64, 8), (64, 6), (32, 3), (64, 0))]
    for args in grid:
        assert qa.supports(*args) == jqa.supports(*args), args
    assert qa.supports(200, 64, 8) and qa.supports(220, 32, 2) and qa.supports(256, 64, 8)
    assert not qa.supports(257, 64, 8) and not qa.supports(1024, 32, 2)
    # the CUDA kernels' own limits: column passes, head dims, shared memory
    assert jqa.supports(200, 16, 2) and not qa.supports(200, 16, 2)
    assert jqa.supports(200, 128, 8) and not qa.supports(200, 128, 8)
    assert jqa.supports(200, 64, 4) and not qa.supports(200, 64, 4)
    assert jqa.supports(200, 64, 1) and not qa.supports(200, 64, 1)
    assert qa.MASK_FILL == jqa.MASK_FILL and qa.MAX_TQ == jqa.MAX_TQ


def _enc_inputs(seed, b, t):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(b, t)).astype(np.float32)),
            torch.from_numpy((rng.random((b, t)) * 100).astype(np.float32)),
            torch.from_numpy(rng.random((b, t)) > 0.2))


@pytest.fixture
def spies(monkeypatch):
    """Counts of the calls the encoders make to the fused-QKV entry and to
    the attention entry of the unfused route."""
    calls = {"qkv": [], "attention": 0}
    real_qkv, real_att = qa.fused_qkv_attention, tm.attention

    def qkv(x, *a, **k):
        calls["qkv"].append(x.dtype)
        return real_qkv(x, *a, **k)

    def att(*a, **k):
        calls["attention"] += 1
        return real_att(*a, **k)

    monkeypatch.setattr(qa, "fused_qkv_attention", qkv)
    monkeypatch.setattr(tm, "attention", att)
    return calls


def test_routing_rules(monkeypatch, spies):
    """Only MMSN_FUSED_QKV == "1", only on the card (here: the patched
    device predicate), only where supports() passes; the fused block wins in
    the blocks it takes."""
    kw = dict(n_out=4, emb=64, heads=8, depth=3, time_norm=1000.0)
    enc = SequenceEncoder(**kw).eval()
    init_weights(enc, torch.Generator().manual_seed(0))
    short, long = _enc_inputs(0, 2, 48), _enc_inputs(1, 2, 264)
    with torch.no_grad():
        monkeypatch.delenv("MMSN_FUSED_QKV", raising=False)
        want = enc(*short)
        monkeypatch.setenv("MMSN_FUSED_QKV", "1")
        enc(*short)                                   # on the CPU: never
        assert spies == {"qkv": [], "attention": 6}
        monkeypatch.setattr(tm, "_on_card", lambda x: True)
        got = enc(*short)
        assert spies == {"qkv": [torch.float32] * 3, "attention": 6}  # once a layer
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
        enc(*long)                                    # T = 264: the flash route
        assert spies == {"qkv": [torch.float32] * 3, "attention": 9}
        for value in ("0", "true", ""):
            monkeypatch.setenv("MMSN_FUSED_QKV", value)
            enc(*short)
        assert len(spies["qkv"]) == 3 and spies["attention"] == 18
        monkeypatch.setenv("MMSN_FUSED_QKV", "1")
        fused = SequenceEncoder(use_fused_block=True, **kw).eval()
        fused.load_state_dict(enc.state_dict())
        got = fused(*short)                           # the fused blocks take no QKV call
        assert len(spies["qkv"]) == 3 and spies["attention"] == 21
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_routed_layers_compute_in_the_configured_dtype(monkeypatch, spies):
    """Under a bf16 policy the routed layers compute in bfloat16 even in the
    two-band tower, whose float32 band embedding promotes the activations
    (the fused block, by contrast, computes in its input's float32)."""
    monkeypatch.setenv("MMSN_FUSED_QKV", "1")
    monkeypatch.setattr(tm, "_on_card", lambda x: True)
    enc = SequenceEncoder(n_out=4, emb=64, heads=8, depth=2, nband=2, agg="attn",
                          time_norm=1000.0, dtype=torch.bfloat16).eval()
    init_weights(enc, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = enc(*_enc_inputs(2, 2, 48))
    assert spies["qkv"] == [torch.bfloat16] * 2 and spies["attention"] == 0
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def _clip_kwargs():
    lc = {"n_out": 8, "emb": 64, "heads": 8, "depth": 2, "time_norm": 2000.0,
          "agg": "attn", "dropout": 0.0}
    sp = {"n_out": 8, "emb": 32, "heads": 2, "depth": 2, "time_norm": 1800.0,
          "agg": "mean", "dropout": 0.0}
    return dict(combinations=("lightcurve", "spectral"), enc_dim=8, nband=2,
                logit_scale_init=19.55, loss="softmax", transformer_kwargs=lc,
                transformer_spectral_kwargs=sp)


def _feed(n=6, seed=0):
    a = make_synthetic_arrays(n=n, n_max_lc=12, nband=2, n_max_sp=20, seed=seed)
    return {k: a[k] for k in FIELDS}


def test_clip_loss_and_grads_match_jax_through_the_weight_bridge(monkeypatch, spies):
    """A JAX CLIPModel's parameters through models/convert.py: the port's
    loss and parameter gradients under the routed fused-QKV path against the
    JAX model's. The JAX side runs unfused: its module route needs a TPU
    backend."""
    jmodel = JaxCLIPModel(JaxCLIPConfig.create(use_pallas=False, **_clip_kwargs()))
    jbatch = Batch(**{k: jnp.asarray(v) for k, v in _feed().items()})
    params = jmodel.init(jax.random.PRNGKey(0), jbatch)["params"]
    feed = _feed(seed=1)
    jbatch = Batch(**{k: jnp.asarray(v) for k, v in feed.items()})
    (want, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jbatch, train=True, method=jmodel.loss_fn),
        has_aux=True)(params)

    monkeypatch.setenv("MMSN_FUSED_QKV", "1")
    monkeypatch.setattr(tm, "_on_card", lambda x: True)
    model = CLIPModel(CLIPConfig.create(**_clip_kwargs()))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           state_dict_from_jax(params).items()}, strict=True)
    got, _ = model.loss_fn({k: torch.from_numpy(v) for k, v in feed.items()},
                           train=True, generator=torch.Generator())
    got.backward()
    assert len(spies["qkv"]) == 4 and spies["attention"] == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    want_grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got_grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got_grads) == sorted(want_grads)
    for name, w in want_grads.items():
        np.testing.assert_allclose(got_grads[name].numpy(), w, rtol=5e-4, atol=5e-4,
                                   err_msg=name)
