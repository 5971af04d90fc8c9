"""The fused kernels' vmap rules (ops/fused_block.py, ops/qkv_attention.py)
on CPU: stacked ensemble members, each with its own parameters, against the
JAX package's fused functions under ``jax.vmap`` (its Pallas kernels under
``pltpu.force_tpu_interpret_mode()``, whose batching rule adds a grid
dimension) and against the JAX functions applied member by member.

The port runs the plain versions of its kernels (CPU tensors); the launch
functions are wrapped to record each call, and a vmapped call must reach
each of them once (forward, backward) with every member in it, whatever the
member count. The kernels themselves are held on the card by chip_smoke.py's
phase ensemble (bitwise against separate calls). Tolerances are the float32
ones of ROADMAP.md: forward 2e-5, gradients 5e-4 of each one's largest; a
stacked fit against the same members fit one by one, relative 1e-5 a step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multimodal_supernovae_tpu.ops import fused_block as jfb
from multimodal_supernovae_tpu.ops import qkv_attention as jqa
from multimodal_supernovae_tpu_torch.data import make_synthetic_dataset
from multimodal_supernovae_tpu_torch.models import CLIPConfig, CLIPModel
from multimodal_supernovae_tpu_torch.models import transformer as tm
from multimodal_supernovae_tpu_torch.ops import fused_block as fb
from multimodal_supernovae_tpu_torch.ops import qkv_attention as qa
from multimodal_supernovae_tpu_torch.training import Trainer, TrainerConfig
from multimodal_supernovae_tpu_torch.training.ensemble import Member, fit_members

M = 3  # members
FWD_TOL, GRAD_TOL = 2e-5, 5e-4


def _assert_grad_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max(), what


@pytest.fixture
def launches(monkeypatch):
    """The four launch functions wrapped: each call's x shape, by kind."""
    calls = {"ffn_fwd": [], "ffn_bwd": [], "qkv_fwd": [], "qkv_bwd": []}
    for mod, name, key, xi in ((fb, "_ffn_fwd", "ffn_fwd", 1),
                               (fb, "fused_ffn_block_bwd", "ffn_bwd", 1),
                               (qa, "_qkv_fwd", "qkv_fwd", 0),
                               (qa, "fused_qkv_attention_bwd", "qkv_bwd", 0)):
        real = getattr(mod, name)

        def wrapped(*a, _real=real, _key=key, _xi=xi, **kw):
            calls[_key].append(tuple(a[_xi].shape))
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


# -- the fused block's row function ------------------------------------------------

N, E, F = 40, 64, 256  # rows, maven-lite's light-curve width and hidden width
WEIGHTS = (2, 6, 8)  # wu, wf1, wf2 among (att, x, the ten parameters)
FFN_CASES = {  # which of (att, x, the ten parameters) carry a member axis
    "stacked": (True,) * 12,
    "x_shared": (True, False) + (True,) * 10,
    "norm2_shared": (True,) * 10 + (False, False),
}


def _ffn_member_inputs(rng):
    """att, x, the ten parameters in the port's layout (weights (out, in)),
    a cotangent; a member axis in front of each."""
    def r(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=(M, *shape)) * scale + shift).astype(np.float32)

    params = [r(E, E, scale=E ** -0.5), r(E, scale=0.1), r(E, scale=0.1, shift=1.0),
              r(E, scale=0.1), r(F, E, scale=E ** -0.5), r(F, scale=0.1),
              r(E, F, scale=F ** -0.5), r(E, scale=0.1), r(E, scale=0.1, shift=1.0),
              r(E, scale=0.1)]
    return [r(N, E), r(N, E), *params], r(N, E)


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_fused_ffn_block_under_vmap_matches_jax_vmap(launches, case):
    batched = FFN_CASES[case]
    arrays, g = _ffn_member_inputs(np.random.default_rng(len(case)))
    arrays = [a if b else a[0] for a, b in zip(arrays, batched)]
    in_axes = tuple(0 if b else None for b in batched)

    def jax_layout(i, a):  # flax kernels (in, out); biases and scales (1, width) rows
        if i in WEIGHTS:
            return jnp.asarray(np.swapaxes(a, -1, -2))
        return jnp.asarray(a if i < 2 else a[..., None, :])

    jargs = [jax_layout(i, a) for i, a in enumerate(arrays)]
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jax.vmap(jfb.fused_ffn_block, in_axes=in_axes), *jargs)
        jgrads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = torch.func.vmap(fb.fused_ffn_block, in_dims=in_axes)(*leaves)
    assert launches["ffn_fwd"] == [(M, N, E)] and launches["ffn_bwd"] == []
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    assert launches["ffn_bwd"] == [(M, N, E)] and len(launches["ffn_fwd"]) == 1
    for i, (a, w) in enumerate(zip(grads, jgrads)):
        w = np.swapaxes(w, -1, -2) if i in WEIGHTS else np.reshape(w, a.shape)
        _assert_grad_close(a.numpy(), w, f"input {i}")
    with torch.no_grad():  # the forward alone: one launch, the same numbers
        again = torch.func.vmap(fb.fused_ffn_block, in_dims=in_axes)(*leaves)
    assert len(launches["ffn_fwd"]) == 2 and len(launches["ffn_bwd"]) == 1
    torch.testing.assert_close(again, got.detach(), atol=0, rtol=0)


@pytest.mark.parametrize("members", [1, 2, 5])
def test_one_launch_each_way_whatever_the_member_count(launches, members):
    """The member count never changes the number of launches, and each
    member's numbers are its own call's."""
    rng = np.random.default_rng(members)
    arrays, g = _ffn_member_inputs(rng)
    arrays = [np.concatenate([a] * 2)[:members] + 0.01 * np.arange(members).reshape(
        (members,) + (1,) * (a.ndim - 1)).astype(np.float32) for a in arrays]
    leaves = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in arrays]
    gt = torch.from_numpy(np.concatenate([g] * 2)[:members])
    out = torch.func.vmap(fb.fused_ffn_block)(*leaves)
    grads = torch.autograd.grad(out, leaves, gt)
    assert launches["ffn_fwd"] == [(members, N, E)] and launches["ffn_bwd"] == [(members, N, E)]
    for i in range(members):
        li = [a.detach()[i].requires_grad_() for a in leaves]
        oi = fb.fused_ffn_block(*li)
        torch.testing.assert_close(out[i], oi, atol=0, rtol=0)
        for a, w in zip(grads, torch.autograd.grad(oi, li, gt[i])):
            torch.testing.assert_close(a[i], w, atol=0, rtol=0)


# -- the whole SelfAttention ---------------------------------------------------------

QKV_CASES = [  # (B, T, E, heads), mask: "stacked", "shared" or None, x stacked
    ((2, 16, 32, 2), "stacked", True), ((2, 24, 64, 8), "stacked", True),
    ((2, 21, 32, 2), "shared", True), ((2, 16, 64, 8), None, True),
    ((2, 19, 64, 8), "stacked", False),
]


@pytest.mark.parametrize("shape,mask,x_stacked", QKV_CASES)
def test_fused_qkv_attention_under_vmap_matches_jax_vmap(launches, shape, mask, x_stacked):
    b, t, e, h = shape
    rng = np.random.default_rng(t + e)
    x = rng.normal(size=(M, b, t, e) if x_stacked else (b, t, e)).astype(np.float32)
    ws = [(rng.normal(size=(M, e, e)) * e ** -0.5).astype(np.float32) for _ in range(4)]
    bu = (rng.normal(size=(M, e)) * 0.1).astype(np.float32)
    g = rng.normal(size=(M, b, t, e)).astype(np.float32)
    m = rng.random((M, b, t)) > 0.3
    m[..., 0] = True
    m = {"stacked": m, "shared": m[0], None: None}[mask]
    m_axis = 0 if mask == "stacked" else None
    x_axis = 0 if x_stacked else None

    def jfn(xx, mm, wq, wk, wv, wu, bb):
        return jqa.fused_qkv_attention(xx, mm, wq, wk, wv, wu, bb, heads=h, emb=e)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(
            lambda xx, *w: jax.vmap(jfn, in_axes=(x_axis, m_axis, 0, 0, 0, 0, 0))(
                xx, None if m is None else jnp.asarray(m), *w),
            jnp.asarray(x), *(jnp.asarray(w) for w in ws), jnp.asarray(bu))
        jgrads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_(),
              *(torch.from_numpy(np.ascontiguousarray(np.swapaxes(w, -1, -2))).requires_grad_()
                for w in ws), torch.from_numpy(bu).requires_grad_()]
    tmask = None if m is None else torch.from_numpy(m)

    def port(xx, mm, wq, wk, wv, wu, bb):
        return qa.fused_qkv_attention(xx, mm, wq, wk, wv, wu, bb, h, e)

    got = torch.func.vmap(port, in_dims=(x_axis, m_axis, 0, 0, 0, 0, 0))(
        leaves[0], tmask, *leaves[1:])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    assert launches["qkv_fwd"] == [(M, b, t, e)] and launches["qkv_bwd"] == [(M, b, t, e)]
    for name, a, w in zip(("x", "wq", "wk", "wv", "wu", "bu"), grads, jgrads):
        w = np.asarray(w)
        _assert_grad_close(a.numpy(), np.swapaxes(w, -1, -2) if name[0] == "w" else w, name)
    with torch.no_grad():
        again = torch.func.vmap(port, in_dims=(x_axis, m_axis, 0, 0, 0, 0, 0))(
            leaves[0], tmask, *leaves[1:])
    assert len(launches["qkv_fwd"]) == 2 and len(launches["qkv_bwd"]) == 1
    torch.testing.assert_close(again, got.detach(), atol=0, rtol=0)


# -- the modules under vmap over stacked parameters ----------------------------------


def _stacked_params(module, rng):
    """Each parameter with M members drawn apart: weights at 1/sqrt(fan-in),
    LayerNorm scales about 1, biases about 0."""
    def draw(name, shape):
        a = rng.normal(size=(M, *shape))
        if len(shape) == 2:
            return a * shape[1] ** -0.5
        return 1.0 + 0.1 * a if name.startswith("norm") and name.endswith("weight") else 0.1 * a

    return {name: torch.from_numpy(draw(name, tuple(p.shape)).astype(np.float32)).requires_grad_()
            for name, p in module.named_parameters()}


def _module_under_vmap(module, params, x, mask):
    def f(p, xx, mm):
        return torch.func.functional_call(module, p, (xx, mm))

    return torch.func.vmap(f)(params, x, mask)


def _module_inputs(rng, b, t, e):
    x = rng.normal(size=(M, b, t, e)).astype(np.float32)
    mask = rng.random((M, b, t)) > 0.3
    mask[..., 0] = True
    return x, mask, rng.normal(size=(M, b, t, e)).astype(np.float32)


def test_fused_transformer_block_under_vmap_matches_jax_per_member(launches):
    b, t, e, h = 2, 20, 64, 8
    rng = np.random.default_rng(5)
    block = tm.TransformerBlock(e, h, use_fused_block=True)
    params = _stacked_params(block, rng)
    x, mask, g = _module_inputs(rng, b, t, e)
    xt = torch.from_numpy(x).requires_grad_()
    assert block.fused(xt[0])
    got = _module_under_vmap(block, params, xt, torch.from_numpy(mask))
    names = list(params)
    grads = torch.autograd.grad(got, [xt, *params.values()], torch.from_numpy(g))
    assert launches["ffn_fwd"] == [(M, b * t, e)] and launches["ffn_bwd"] == [(M, b * t, e)]
    jax_keys = {"attention.toqueries.weight": "toqueries", "attention.tokeys.weight": "tokeys",
                "attention.tovalues.weight": "tovalues",
                "attention.unifyheads.weight": "unifyheads_kernel",
                "attention.unifyheads.bias": "unifyheads_bias", "norm1.weight": "norm1_scale",
                "norm1.bias": "norm1_bias", "ff.0.weight": "ff_in_kernel",
                "ff.0.bias": "ff_in_bias", "ff.2.weight": "ff_out_kernel",
                "ff.2.bias": "ff_out_bias", "norm2.weight": "norm2_scale",
                "norm2.bias": "norm2_bias"}
    assert sorted(jax_keys) == sorted(names)
    for i in range(M):
        jp = {jax_keys[n]: jnp.asarray(p.detach().numpy()[i].T if p.dim() == 3
                                       else p.detach().numpy()[i]) for n, p in params.items()}
        with pltpu.force_tpu_interpret_mode():
            want, vjp = jax.vjp(lambda xx, pp: jfb.fused_transformer_block(
                xx, jnp.asarray(mask[i]), pp, h), jnp.asarray(x[i]), jp)
            jgx, jgp = vjp(jnp.asarray(g[i]))
        np.testing.assert_allclose(got[i].detach().numpy(), np.asarray(want), rtol=FWD_TOL,
                                   atol=FWD_TOL)
        _assert_grad_close(grads[0][i].numpy(), jgx, f"member {i} x")
        for n, a in zip(names, grads[1:]):
            w = np.asarray(jgp[jax_keys[n]])
            _assert_grad_close(a[i].numpy(), w.T if w.ndim == 2 else w, f"member {i} {n}")


def test_fused_self_attention_under_vmap_matches_jax_per_member(launches, monkeypatch):
    b, t, e, h = 2, 24, 64, 8
    monkeypatch.setenv("MMSN_FUSED_QKV", "1")
    monkeypatch.setattr(tm, "_on_card", lambda a: True)
    rng = np.random.default_rng(6)
    sa = tm.SelfAttention(e, h)
    params = _stacked_params(sa, rng)
    x, mask, g = _module_inputs(rng, b, t, e)
    xt = torch.from_numpy(x).requires_grad_()
    got = _module_under_vmap(sa, params, xt, torch.from_numpy(mask))
    grads = torch.autograd.grad(got, [xt, *params.values()], torch.from_numpy(g))
    assert launches["qkv_fwd"] == [(M, b, t, e)] and launches["qkv_bwd"] == [(M, b, t, e)]
    names = {"toqueries.weight": 1, "tokeys.weight": 2, "tovalues.weight": 3,
             "unifyheads.weight": 4, "unifyheads.bias": 5}
    order = ["toqueries.weight", "tokeys.weight", "tovalues.weight", "unifyheads.weight",
             "unifyheads.bias"]
    assert sorted(params) == sorted(order)
    for i in range(M):
        w = [params[n].detach().numpy()[i] for n in order]
        with pltpu.force_tpu_interpret_mode():
            want, vjp = jax.vjp(
                lambda xx, *ww: jqa.fused_qkv_attention(xx, jnp.asarray(mask[i]), *ww,
                                                        heads=h, emb=e),
                jnp.asarray(x[i]), *(jnp.asarray(a.T) for a in w[:4]), jnp.asarray(w[4]))
            jgrads = vjp(jnp.asarray(g[i]))
        np.testing.assert_allclose(got[i].detach().numpy(), np.asarray(want), rtol=FWD_TOL,
                                   atol=FWD_TOL)
        _assert_grad_close(grads[0][i].numpy(), jgrads[0], f"member {i} x")
        for n in order:
            k = names[n]
            jw = np.asarray(jgrads[k])
            a = grads[1 + list(params).index(n)][i].numpy()
            _assert_grad_close(a, jw.T if jw.ndim == 2 else jw, f"member {i} {n}")


# -- a stacked fit with both opt-ins ------------------------------------------------


def _fused_model(seed):
    """A bimodal model whose light-curve blocks take the fused block (E = 64,
    explicit use_fused_block, dropout 0) and whose spectral attention takes
    the fused QKV (E = 32, 2 heads) under MMSN_FUSED_QKV=1."""
    lc = {"n_out": 8, "emb": 64, "heads": 8, "depth": 1, "time_norm": 1000.0, "agg": "mean",
          "dropout": 0.0, "use_fused_block": True}
    sp = {"n_out": 8, "emb": 32, "heads": 2, "depth": 1, "time_norm": 1000.0, "agg": "mean",
          "dropout": 0.0}
    cfg = CLIPConfig.create(combinations=("lightcurve", "spectral"), enc_dim=8, nband=2,
                            logit_scale_init=10.0, loss="softmax", transformer_kwargs=lc,
                            transformer_spectral_kwargs=sp)
    return CLIPModel(cfg, generator=torch.Generator().manual_seed(seed))


def test_fit_members_with_both_opt_ins_tracks_sequential_fits(launches, monkeypatch):
    """2 members, 2 steps (one a epoch) as one stacked program with both
    fused opt-ins, against each member fit alone with the same opt-ins:
    every step's train loss and every epoch's validation loss within
    relative 1e-5, and every stacked step reaching each fused launch
    function once each way with both members in it."""
    monkeypatch.setenv("MMSN_FUSED_QKV", "1")
    monkeypatch.setattr(tm, "_on_card", lambda a: True)
    ds = make_synthetic_dataset(n=32, seed=4, n_max_lc=10, nband=2, n_max_sp=12)
    idx = np.arange(32)
    members = [Member("run-0", 3, idx[:8], idx[16:24]), Member("run-1", 7, idx[8:16], idx[24:])]
    cfg = TrainerConfig(epochs=2, batch_size=8, lr=3e-3, noise_level_mag=1.0)
    models = [_fused_model(m.seed) for m in members]
    res = fit_members([copy.deepcopy(x) for x in models], "contrastive", cfg, ds, members)
    stacked_calls = {k: [s for s in v if s[0] == len(members)] for k, v in launches.items()}
    # two train steps, each one launch a way a fused layer; the validation passes
    # (no grad) add forwards only
    assert len(stacked_calls["ffn_bwd"]) == 2 and len(stacked_calls["qkv_bwd"]) == 2
    assert len(stacked_calls["ffn_fwd"]) >= 2 and len(stacked_calls["qkv_fwd"]) >= 2
    for m, model in zip(members, models):
        c = TrainerConfig(**{**cfg.__dict__, "seed": m.seed})
        seq = Trainer(model, "contrastive", c).fit(ds.subset(m.train_indices),
                                                   ds.subset(m.val_indices))
        par = res["members"][m.name]
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(par["history"][key], seq["history"][key], rtol=1e-5,
                                       atol=0, err_msg=f"{m.name} {key}")
