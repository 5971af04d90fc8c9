"""The port's serving path on CPU against the JAX model: the JAX package
writes a run directory (``model_config.json`` sidecar + a reference-layout
``.ckpt``), the port serves it through ``load_live`` and its own
``EmbedServer``, and every answer equals JAX ``encode`` (float32, 1e-4)."""

import dataclasses
import io
import json
import urllib.request

import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu.models.factory import read_model_config as jax_read
from multimodal_supernovae_tpu.models.factory import write_model_config
from multimodal_supernovae_tpu.models.torch_export import export_reference_checkpoint
from multimodal_supernovae_tpu_torch import models as port_models
from multimodal_supernovae_tpu_torch.cli.serve import build_parser, main
from multimodal_supernovae_tpu_torch.models import pick_reference_ckpt, read_model_config
from multimodal_supernovae_tpu_torch.serving import EmbedServer, load_live

from tests.test_torch_clip import (
    _jax_batch,
    jax_model_and_params,
    small_cfg_kwargs,
    small_feed,
)

BATCH = 4


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("run")
    model, params = jax_model_and_params(seed=5)
    assert write_model_config(str(d), model)
    export_reference_checkpoint(params, str(d / "epoch=3-step=0.ckpt"))
    return d, model, params


def _jax_encode(run_dir, feed):
    _, model, params = run_dir
    return [np.asarray(o) for o in
            model.apply({"params": params}, _jax_batch(feed), method=model.encode)]


def _post(port, feed, as_json):
    if as_json:
        body = json.dumps({k: v.tolist() for k, v in feed.items()}).encode()
        ctype = "application/json"
    else:
        buf = io.BytesIO()
        np.savez(buf, **feed)
        body, ctype = buf.getvalue(), "application/x-npz"
    req = urllib.request.Request(f"http://127.0.0.1:{port}/embed", body,
                                 {"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
        data = r.read()
    if as_json:
        return {k: np.asarray(v, np.float32) for k, v in json.loads(data).items()}
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


def test_load_live_contract(run_dir):
    sm = load_live(str(run_dir[0]), BATCH, device="cpu", lc_len=12, sp_len=20)
    assert sm.modalities == ["lightcurve", "spectral"]
    assert sm.batch_size == BATCH
    assert {k: (s, str(d)) for k, (s, d) in sm.input_spec.items()} == {
        "x_lc": ((24,), "float32"), "t_lc": ((24,), "float32"),
        "mask_lc": ((24,), "bool"), "x_sp": ((20,), "float32"),
        "t_sp": ((20,), "float32"), "mask_sp": ((20,), "bool")}
    feed = small_feed(n=BATCH, seed=1)
    got = sm.fn(feed)
    assert all(isinstance(o, np.ndarray) and o.dtype == np.float32 for o in got)
    for g, w in zip(got, _jax_encode(run_dir, feed)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("as_json,n", [(False, 3), (False, 2 * BATCH + 1), (True, 5)])
def test_server_answers_equal_jax_encode(run_dir, as_json, n):
    sm = load_live(str(run_dir[0]), BATCH, device="cpu", lc_len=12, sp_len=20)
    srv = EmbedServer(sm, max_wait_ms=1.0).start_background()
    try:
        feed = small_feed(n=n, seed=n)
        out = _post(srv.port, feed, as_json)
        want = _jax_encode(run_dir, feed)
        for name, w in zip(("emb_lightcurve", "emb_spectral"), want):
            assert out[name].shape == (n, 8)
            np.testing.assert_allclose(out[name], w, rtol=1e-4, atol=1e-4)
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/stats", timeout=30).read())
        assert stats["samples"] == n
        assert stats["device_calls"] == -(-n // BATCH)
    finally:
        srv.close()


def test_cli_refuses_missing_cuda(run_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--run-dir", str(run_dir[0]), "--port", "0"])
    args = build_parser().parse_args(["--run-dir", "x"])
    assert args.device == "cuda" and args.batch_size == 256


def test_port_sidecar_reads_back_on_both_sides(tmp_path):
    model = port_models.CLIPModel(
        port_models.CLIPConfig.create(**small_cfg_kwargs("bfloat16")))
    port_models.write_model_config(str(tmp_path), model)
    jmodel, jextra = jax_read(str(tmp_path))
    assert dataclasses.asdict(jmodel.cfg) == dataclasses.asdict(model.cfg)
    cfg, extra = read_model_config(str(tmp_path))
    assert cfg == model.cfg and extra == jextra
    assert extra["combinations"] == ["lightcurve", "spectral"] and extra["nband"] == 2


def test_pick_reference_ckpt_follows_the_reference(tmp_path):
    for name in ("epoch=12-step=0.ckpt", "epoch=3-step=9.ckpt", "last.ckpt"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "epoch=0-step=0.ckpt").symlink_to(tmp_path / "gone")  # dangling
    assert pick_reference_ckpt(str(tmp_path)).endswith("epoch=3-step=9.ckpt")
    assert pick_reference_ckpt(str(tmp_path), "last").endswith("last.ckpt")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no .ckpt"):
        pick_reference_ckpt(str(empty))
