"""The port's serving artifact (``evaluation/export.py`` over ``torch.export``)
on the CPU: every case of the JAX package's tests/test_export.py as a case of
the port, the port's artifact against the JAX package's StableHLO artifact on
the same weights and inputs (1e-4) and against the port's live ``encode``
(rtol 1e-5, atol 1e-6), the three registered kernel ops (each one graph node,
with the real output's shape and strides, through ``torch.export.save`` and
``load``; on the CPU a plain-version implementation is registered for the
test's scope), ``export-model --check`` and ``serve --artifact`` through the
umbrella command, and a host that loads an artifact without the model code."""

import io
import json
import os
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu.data.batching import Batch
from multimodal_supernovae_tpu.evaluation import export as jax_export
from multimodal_supernovae_tpu.models import CLIPModel as JaxCLIPModel
from multimodal_supernovae_tpu.models.factory import write_model_config
from multimodal_supernovae_tpu.models.torch_export import export_reference_checkpoint
from multimodal_supernovae_tpu_torch import cli
from multimodal_supernovae_tpu_torch.evaluation.export import (
    ENCODE_FIELDS,
    MODALITIES,
    batch_to_dict,
    encode_input_fields,
    export_encoder,
    kernel_ops,
    load_exported,
    modality_names,
)
from multimodal_supernovae_tpu_torch.models import CLIPConfig, CLIPModel, state_dict_from_jax
from multimodal_supernovae_tpu_torch.models.clip import MODALITIES as CLIP_MODALITIES
from multimodal_supernovae_tpu_torch.ops import dense_attention
from multimodal_supernovae_tpu_torch.ops import flash_attention as flash_mod
from multimodal_supernovae_tpu_torch.ops import fused_block as ffn_mod
from multimodal_supernovae_tpu_torch.ops import qkv_attention as qkv_mod
from multimodal_supernovae_tpu_torch.serving import EmbedServer, load_artifact

from tests.test_clip_model import tiny_batch, tiny_cfg

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
VIT = {"emb": 16, "depth": 1, "heads": 2, "patch_size": 5, "n_out": 6}


def _cfg_kwargs(cfg):
    """The port's ``CLIPConfig.create`` keywords of a JAX config."""
    return {k: getattr(cfg, k) for k in (
        "combinations", "enc_dim", "nband", "transformer_kwargs",
        "transformer_spectral_kwargs", "conv_kwargs", "meta_kwargs", "image_encoder",
        "vit_kwargs")}


def _pair(seed=0, **kw):
    """(JAX model, its variables, the port's model on the same weights, a
    JAX batch, the same batch as torch tensors) of ``tiny_cfg(**kw)``."""
    rng = np.random.default_rng(seed)
    cfg = tiny_cfg(**kw)
    batch = tiny_batch(rng, with_img="host_galaxy" in cfg.combinations)
    jmodel = JaxCLIPModel(cfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), batch)
    model = CLIPModel(CLIPConfig.create(**_cfg_kwargs(cfg)), image_size=20)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables["params"]),
                             jax.tree_util.tree_map(np.asarray,
                                                    variables.get("batch_stats", {})))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in vars(batch).items()
              if v is not None}
    return jmodel, variables, model.eval(), batch, tbatch


CASES = {
    "bimodal": {},
    "trimodal-vit": dict(combinations=("host_galaxy", "lightcurve", "spectral"),
                         image_encoder="vit", vit_kwargs=VIT),
    "quadrimodal": dict(combinations=("host_galaxy", "lightcurve", "spectral", "meta")),
}


@pytest.fixture(scope="module")
def exported():
    """{case: (port model, torch batch, artifact bytes, JAX model, variables,
    JAX batch)}: each case exported once."""
    out = {}
    for name, kw in CASES.items():
        jmodel, variables, model, batch, tbatch = _pair(**kw)
        out[name] = (model, tbatch, export_encoder(model, tbatch), jmodel, variables, batch)
    return out


def _roundtrip(exported, name):
    model, tbatch, data, *_ = exported[name]
    assert isinstance(data, bytes) and len(data) > 0
    fn, ep = load_exported(data)
    got = fn(batch_to_dict(tbatch, model.cfg.combinations))
    with torch.no_grad():
        want = model.encode(tbatch)
    assert len(got) == len(want) == len(modality_names(model))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
    return ep


def test_export_roundtrip_bimodal(exported):
    ep = _roundtrip(exported, "bimodal")
    # metadata for serving-host shape validation
    assert len(ep.graph_signature.user_inputs) == 6
    assert kernel_ops(ep) == {}  # the CPU export holds the plain versions


def test_export_roundtrip_trimodal_with_vit(exported):
    _roundtrip(exported, "trimodal-vit")


@pytest.mark.parametrize("name", list(CASES))
def test_artifact_matches_the_jax_artifact(exported, name):
    """The port's artifact and the JAX package's StableHLO artifact, on the
    same weights and the same seeded inputs, within 1e-4."""
    model, tbatch, data, jmodel, variables, batch = exported[name]
    jfn, _ = jax_export.load_exported(jax_export.export_encoder(jmodel, variables, batch))
    want = jfn(jax_export.batch_to_dict(batch, jmodel.cfg.combinations))
    fn, _ = load_exported(data)
    got = fn({k: np.asarray(v) for k, v in
              jax_export.batch_to_dict(batch, jmodel.cfg.combinations).items()})
    assert len(got) == len(want) == len(model.cfg.combinations)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_export_artifact_needs_no_model_code(exported):
    """The artifact input is a plain dict of numpy arrays: a host that only
    has the bytes (no CLIPModel, no batch class) can serve it."""
    model, tbatch, data, *_ = exported["bimodal"]
    plain = {k: v.numpy() for k, v in batch_to_dict(tbatch, model.cfg.combinations).items()}
    fn, _ = load_exported(data)
    out = fn(plain)  # numpy dict in, no package classes involved
    assert all(np.isfinite(o.numpy()).all() for o in out)


def test_export_rejects_wrong_shapes(exported):
    model, _, data, *_ = exported["bimodal"]
    fn, _ = load_exported(data)
    # exported at b=4
    big = tiny_batch(np.random.default_rng(1), b=8)
    bad = {k: np.asarray(v) for k, v in batch_to_dict(vars(big), model.cfg.combinations).items()}
    with pytest.raises(Exception):
        fn(bad)


def test_batch_to_dict_drops_absent_modalities():
    batch = {k: np.asarray(v) if v is not None else None
             for k, v in vars(tiny_batch(np.random.default_rng(0))).items()}  # no image
    d = batch_to_dict(batch)
    assert "x_img" not in d and "x_lc" in d
    assert all(v is not None for v in d.values())
    assert list(d) == list(jax_export.batch_to_dict(Batch(**batch)))


def test_serving_contract_excludes_training_only_fields(exported):
    """The artifact's required inputs are exactly the fields encode reads:
    no err_lc/err_sp (augmentation-only), no redshift/label unless the
    model has a meta tower; the JAX contract field for field."""
    assert encode_input_fields(("lightcurve", "spectral")) == (
        "x_lc", "t_lc", "mask_lc", "x_sp", "t_sp", "mask_sp")
    assert "redshift" in encode_input_fields(("meta",))
    assert ENCODE_FIELDS == jax_export.ENCODE_FIELDS and MODALITIES == CLIP_MODALITIES
    for combos in (("lightcurve",), ("host_galaxy", "spectral", "meta"), MODALITIES):
        assert encode_input_fields(combos) == jax_export.encode_input_fields(combos)

    model, tbatch, data, *_ = exported["bimodal"]
    fn, _ = load_exported(data)
    d = batch_to_dict(tbatch, model.cfg.combinations)
    assert set(d) == {"x_lc", "t_lc", "mask_lc", "x_sp", "t_sp", "mask_sp"}
    # the exported pytree agrees: passing the full batch dict (with err
    # fields) is a structure mismatch, the filtered dict is accepted
    with pytest.raises(Exception):
        fn(batch_to_dict(tbatch))
    out = fn(d)
    assert len(out) == 2


# -- the registered kernel ops ------------------------------------------------------


def _flash_plain(q, k, v, key_mask, emb):
    return flash_mod._empty_heads(q).copy_(dense_attention(q, k, v, key_mask, emb))


def _ffn_plain(att, x, *params_eps):
    *params, eps = params_eps
    return ffn_mod.fused_ffn_block_plain(att, x, *params, eps=eps).contiguous()


def _qkv_plain(x, mask, wqkv, wu, bu, heads):
    return qkv_mod.fused_qkv_attention_plain(x, mask, wqkv, wu, bu, heads).contiguous()


@pytest.fixture
def plain_cpu_ops():
    """The plain versions registered as the three ops' CPU implementations,
    for the test's scope only."""
    lib = torch.library.Library("mmsn_torch", "IMPL")
    lib.impl("flash_attention_fwd", _flash_plain, "CPU")
    lib.impl("fused_ffn_block_fwd", _ffn_plain, "CPU")
    lib.impl("fused_qkv_attention_fwd", _qkv_plain, "CPU")
    yield
    lib._destroy()


class _Flash(torch.nn.Module):
    def forward(self, x, mask):
        b, t, e = x.shape
        q = x.view(b, t, 2, e // 2).transpose(1, 2)  # the encoder's head split: a view
        out = flash_mod.flash_attention_fwd(q, q * 0.5, q + 1.0, mask, e)
        return out.transpose(1, 2).reshape(b, t, e)


class _FFN(torch.nn.Module):
    def __init__(self, e=32, f=64):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        shapes = ((e, e), (e,), (e,), (e,), (f, e), (f,), (e, f), (e,), (e,), (e,))
        self.params = torch.nn.ParameterList(
            [torch.nn.Parameter(0.2 * torch.randn(s, generator=g)) for s in shapes])

    def forward(self, att, x):
        return ffn_mod.fused_ffn_block_fwd(att, x, *self.params, ffn_mod.LN_EPS)


class _QKV(torch.nn.Module):
    def __init__(self, e=32):
        super().__init__()
        g = torch.Generator().manual_seed(1)
        self.wqkv = torch.nn.Parameter(0.2 * torch.randn(3 * e, e, generator=g))
        self.wu = torch.nn.Parameter(0.2 * torch.randn(e, e, generator=g))
        self.bu = torch.nn.Parameter(0.1 * torch.randn(e, generator=g))

    def forward(self, x, mask):
        return qkv_mod.fused_qkv_attention_fwd(x, mask, self.wqkv, self.wu, self.bu, 2)


def _op_case(name):
    """(module, its args, the op's own args in the module's call, the plain
    output) of one op at a small shape."""
    g = torch.Generator().manual_seed(2)
    mask = torch.rand(3, 7, generator=g) > 0.3
    mask[:, 0] = True
    if name == "flash_attention_fwd":
        x = torch.randn(3, 7, 16, generator=g)
        q = x.view(3, 7, 2, 8).transpose(1, 2)
        want = dense_attention(q, q * 0.5, q + 1.0, mask, 16).transpose(1, 2).reshape(3, 7, 16)
        return _Flash(), (x, mask), (q, q * 0.5, q + 1.0, mask, 16), want
    if name == "fused_ffn_block_fwd":
        m = _FFN()
        att, x = torch.randn(10, 32, generator=g), torch.randn(10, 32, generator=g)
        return (m, (att, x), (att, x, *m.params, ffn_mod.LN_EPS),
                ffn_mod.fused_ffn_block_plain(att, x, *m.params))
    m = _QKV()
    x = torch.randn(3, 7, 32, generator=g)
    return (m, (x, mask), (x, mask, m.wqkv, m.wu, m.bu, 2),
            qkv_mod.fused_qkv_attention_plain(x, mask, m.wqkv, m.wu, m.bu, 2))


OPS = ("flash_attention_fwd", "fused_ffn_block_fwd", "fused_qkv_attention_fwd")


@pytest.mark.parametrize("name", OPS)
def test_kernel_op_exports_as_one_node(plain_cpu_ops, name):
    """The op is one node of the exported graph; the fake implementation
    gives the real call's shape, dtype and strides; the program survives
    ``torch.export.save`` / ``load`` and computes the plain version."""
    module, args, op_args, want = _op_case(name)
    with torch.no_grad():
        ep = torch.export.export(module, args, strict=False)
        real = getattr(torch.ops.mmsn_torch, name)(*op_args)
    nodes = [n for n in ep.graph.nodes
             if n.op == "call_function" and str(n.target) == f"mmsn_torch.{name}.default"]
    assert len(nodes) == 1 and kernel_ops(ep) == {name: 1}
    fake = nodes[0].meta["val"]
    assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype, real.stride())
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue()))
    assert kernel_ops(loaded) == {name: 1}
    with torch.no_grad():
        got = loaded.module()(*args)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5,
                               atol=1e-6)


def test_flash_op_fake_keeps_the_head_split_view_strides():
    """The flash op's fake output is a (B, H, T, S) view of (B, T, H, S)
    memory, as ``_empty_heads`` makes the real one."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(4, 9, 2, 8).transpose(1, 2)
        out = flash_mod._flash_attention_fwd_fake(q, q, q, None, 16)
    assert out.shape == (4, 2, 9, 8) and out.stride() == (144, 8, 16, 1)
    assert out.transpose(1, 2).is_contiguous()


def test_kernel_ops_have_no_cpu_implementation():
    """Without a registered CPU implementation a CPU call of an op raises:
    an artifact exported from the card never runs the plain versions."""
    x = torch.randn(2, 4, 2, 8).transpose(1, 2)
    with pytest.raises(NotImplementedError):
        flash_mod.flash_attention_fwd(x, x, x, None, 16)


# -- the CLI and the serving host ----------------------------------------------------


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A JAX-written run dir (sidecar + reference-layout checkpoint) of the
    bimodal tiny model, and its artifact by ``export-model --check``."""
    d = tmp_path_factory.mktemp("run")
    jmodel, variables, *_ = _pair(seed=5)
    assert write_model_config(str(d), jmodel)
    export_reference_checkpoint(variables["params"], str(d / "epoch=3-step=0.ckpt"))
    art = d / "model.pt2"
    assert cli.main(["export-model", str(d), "--out", str(art), "--batch-size", "4",
                     "--lc-len", "5", "--sp-len", "8", "--device", "cpu", "--check"]) == 0
    return d, art


def test_export_cli(run_dir, capsys):
    """``export-model`` end to end through the umbrella: the artifact, the
    manifest of the JAX CLI's keys and exactly the fields encode reads; the
    bytes alone are servable."""
    d, art = run_dir
    manifest = json.load(open(str(art) + ".json"))
    assert list(manifest) == ["artifact", "bytes", "platforms", "batch_size", "input",
                              "output_modalities", "run_dir", "which"]
    assert manifest["batch_size"] == 4 and manifest["platforms"] == ["cpu"]
    assert manifest["bytes"] == os.path.getsize(art)
    assert manifest["output_modalities"] == ["lightcurve", "spectral"]
    assert manifest["input"] == {
        "x_lc": {"shape": [4, 10], "dtype": "float32"},
        "t_lc": {"shape": [4, 10], "dtype": "float32"},
        "mask_lc": {"shape": [4, 10], "dtype": "bool"},
        "x_sp": {"shape": [4, 8], "dtype": "float32"},
        "t_sp": {"shape": [4, 8], "dtype": "float32"},
        "mask_sp": {"shape": [4, 8], "dtype": "bool"}}
    fn, _ = load_exported(open(art, "rb").read())
    feed = {k: np.zeros(v["shape"], dtype=v["dtype"]) for k, v in manifest["input"].items()}
    outs = fn(feed)
    assert len(outs) == 2 and outs[0].shape == (4, 4)


def test_export_cli_refuses_a_run_without_an_encoder(tmp_path, capsys):
    from multimodal_supernovae_tpu_torch.models import (
        MaskedEncoderConfig,
        MaskedLightCurveEncoder,
    )
    from multimodal_supernovae_tpu_torch.models import write_model_config as port_write

    model = MaskedLightCurveEncoder(MaskedEncoderConfig.create(
        nband=2, transformer_kwargs={"emb": 8, "heads": 2, "depth": 1}))
    assert port_write(str(tmp_path), model)
    torch.save({"state_dict": model.state_dict()}, tmp_path / "last.ckpt")
    with pytest.raises(SystemExit, match="has no embedding encoder to export"):
        cli.main(["export-model", str(tmp_path), "--out", str(tmp_path / "a"),
                  "--which", "last", "--device", "cpu"])


def _load_in_fresh_process(art):
    code = (
        "import sys, json\n"
        "from multimodal_supernovae_tpu_torch.serving import load_artifact\n"
        f"m = load_artifact({str(art)!r}, device='cpu')\n"
        "m.warmup()\n"
        "print(json.dumps({'models': sorted(k for k in sys.modules if k.startswith("
        "'multimodal_supernovae_tpu_torch.models')), 'jax': sorted(k for k in sys.modules"
        " if k.split('.')[0] in ('jax', 'flax', 'multimodal_supernovae_tpu')),"
        " 'batch': m.batch_size, 'modalities': m.modalities}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_load_artifact_imports_no_model_code(run_dir):
    got = _load_in_fresh_process(run_dir[1])
    assert got == {"models": [], "jax": [], "batch": 4,
                   "modalities": ["lightcurve", "spectral"]}


def test_load_artifact_serves_the_live_answers(run_dir):
    """``load_artifact`` behind ``EmbedServer``: the answers equal the
    artifact's own call and the live encode of the run dir (1e-5)."""
    from multimodal_supernovae_tpu_torch.serving import load_live

    d, art = run_dir
    sm = load_artifact(str(art), device="cpu")
    assert sm.meta["source"] == "artifact" and sm.meta["platforms"] == ["cpu"]
    live = load_live(str(d), 4, device="cpu", lc_len=5, sp_len=8)
    assert {k: (s, str(t)) for k, (s, t) in sm.input_spec.items()} == {
        k: (s, str(t)) for k, (s, t) in live.input_spec.items()}
    feed = {k: np.asarray(v) for k, v in
            batch_to_dict(vars(tiny_batch(np.random.default_rng(3), b=3, t=10, s=8)),
                          ("lightcurve", "spectral")).items()}
    srv = EmbedServer(sm, max_wait_ms=1.0).start_background()
    try:
        buf = io.BytesIO()
        np.savez(buf, **feed)
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/embed", buf.getvalue(),
                                     {"Content-Type": "application/x-npz"})
        with np.load(io.BytesIO(urllib.request.urlopen(req, timeout=60).read())) as z:
            out = {k: z[k] for k in z.files}
    finally:
        srv.close()
    padded = {k: np.concatenate([v, np.zeros((1,) + v.shape[1:], v.dtype)])
              for k, v in feed.items()}
    for name, w in zip(("emb_lightcurve", "emb_spectral"), live.fn(padded)):
        np.testing.assert_allclose(out[name], w[:3], rtol=1e-5, atol=1e-5)


def test_artifact_runs_only_on_its_device_type(run_dir):
    """A CPU-exported artifact (the plain versions) is not run on another
    device type: the card would then run no kernel."""
    data = open(run_dir[1], "rb").read()
    with pytest.raises(ValueError, match="exported on cpu, not meta"):
        load_exported(data, device="meta")
    assert load_exported(data, device="cpu")[1].graph is not None


def test_load_artifact_refuses_missing_cuda(run_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_artifact(str(run_dir[1]))


def test_serve_artifact_cli(run_dir):
    """``serve --artifact`` through the umbrella in its own process: /healthz
    names the artifact's contract, /embed answers, /stats counts."""
    _, art = run_dir
    proc = subprocess.Popen(
        [sys.executable, "-m", "multimodal_supernovae_tpu_torch", "serve", "--artifact",
         str(art), "--port", "0", "--device", "cpu", "--quiet"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line, proc.stderr.read()[-3000:]
        info = json.loads(line)
        assert info["serving"] and info["source"] == "artifact" and info["batch_size"] == 4
        base = f"http://127.0.0.1:{info['port']}"
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=30).read())
        assert health["status"] == "ok" and health["input"]["x_lc"] == {
            "shape": ["n", 10], "dtype": "float32"}
        feed = {"x_lc": np.ones((2, 10), np.float32).tolist(),
                "t_lc": np.ones((2, 10), np.float32).tolist(),
                "mask_lc": np.ones((2, 10), bool).tolist(),
                "x_sp": np.ones((2, 8), np.float32).tolist(),
                "t_sp": np.ones((2, 8), np.float32).tolist(),
                "mask_sp": np.ones((2, 8), bool).tolist()}
        req = urllib.request.Request(f"{base}/embed", json.dumps(feed).encode(),
                                     {"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert np.asarray(out["emb_spectral"]).shape == (2, 4)
        np.testing.assert_allclose(np.linalg.norm(out["emb_lightcurve"], axis=1), 1.0,
                                   rtol=1e-5)
        stats = json.loads(urllib.request.urlopen(f"{base}/stats", timeout=30).read())
        assert stats["samples"] == 2 and stats["device_calls"] == 1
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
