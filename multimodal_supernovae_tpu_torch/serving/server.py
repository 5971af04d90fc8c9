"""Serve a run directory's embeddings from PyTorch (port of
multimodal_supernovae_tpu/serving/server.py).

Stdlib-only HTTP host (http.server + npz/json wire formats) over the
``DynamicBatcher`` (serving/batcher.py). Endpoints, as in the JAX package:

  * ``GET  /healthz``  -> JSON: status, batch size, modalities, the exact
    input contract (field -> shape/dtype) and the model's meta.
  * ``GET  /stats``    -> JSON: request/sample/device-call counters, batch
    fill, latency percentiles (``BatcherStats``).
  * ``POST /embed``    -> an ``.npz`` body (``Content-Type:
    application/x-npz``) or JSON ``{field: nested lists}``; the response
    mirrors the request format with one ``emb_<modality>`` array per
    tower. Any leading dim n >= 1 is accepted: the batcher chunks and
    coalesces onto the fixed device batch.

Two model sources (cli/serve.py), as in the JAX package:

  * ``load_artifact(path)``: the ``cli/export_model.py`` artifact (the bytes
    of ``torch.export.save`` + the ``<path>.json`` manifest). No model code
    is imported (``evaluation/export.py:load_exported`` needs only the
    registered kernel ops of ``ops``), and no checkpoint is read.
  * ``load_live(run_dir, batch_size)``: a run directory, whose ``fn`` runs
    ``CLIPModel.encode`` on ``device``.

Both load on the card unless the caller asks for the CPU, and neither falls
back to it. The input contract is the JAX one, per modality: ``x_img``
(image_size, image_size, channels) float32 NHWC; ``x_lc, t_lc, mask_lc`` of
width ``nband * lc_len`` and ``x_sp, t_sp, mask_sp`` of width ``sp_len``
(float32, float32, bool); ``label`` int32 and ``redshift`` float32 per
sample for the meta tower; one float32 ``(n, enc_dim)`` output per
modality.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .batcher import DynamicBatcher

__all__ = ["EmbedServer", "ServingModel", "input_spec", "load_artifact", "load_live", "serve"]


class ServingModel:
    """What the server needs: a fixed-batch callable + its input contract."""

    def __init__(self, fn, input_spec: Dict[str, Tuple[Tuple[int, ...], str]],
                 batch_size: int, modalities, meta: Optional[Dict] = None):
        self.fn = fn
        self.input_spec = {k: (tuple(s), np.dtype(d))
                           for k, (s, d) in input_spec.items()}
        self.batch_size = int(batch_size)
        self.modalities = list(modalities)
        self.meta = dict(meta or {})

    def warmup(self):
        """One zero-batch call, so that kernel builds and first-call costs
        come before traffic."""
        feed = {k: np.zeros((self.batch_size,) + s, d)
                for k, (s, d) in self.input_spec.items()}
        outs = self.fn(feed)
        if len(outs) != len(self.modalities):
            raise RuntimeError(
                f"model returned {len(outs)} outputs for "
                f"{len(self.modalities)} modalities")
        float(np.asarray(outs[0]).sum())


def input_spec(combinations, nband: int, lc_len: int, sp_len: int,
               image_size: int = 60, channels: int = 3) -> Dict:
    """``{field: (trailing shape, dtype)}`` of the fields encode reads."""
    spec = {}
    if "host_galaxy" in combinations:
        spec["x_img"] = ((image_size, image_size, channels), "float32")
    if "lightcurve" in combinations:
        w = nband * lc_len
        spec.update(x_lc=((w,), "float32"), t_lc=((w,), "float32"),
                    mask_lc=((w,), "bool"))
    if "spectral" in combinations:
        spec.update(x_sp=((sp_len,), "float32"), t_sp=((sp_len,), "float32"),
                    mask_sp=((sp_len,), "bool"))
    if "meta" in combinations:
        spec.update(label=((), "int32"), redshift=((), "float32"))
    return spec


def _host_outputs(fn):
    """``fn`` whose outputs come back as float32 host numpy arrays, which
    the batcher's fetcher needs (the copy back is synchronous)."""
    def host(feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        return [o.float().cpu().numpy() for o in fn(feed)]

    return host


def load_artifact(path: str, device="cuda") -> ServingModel:
    """A ServingModel from ``cli/export_model.py``'s artifact and its
    ``<path>.json`` manifest, on ``device`` (the card unless the caller asks
    for the CPU; raises when CUDA is asked for and absent). The artifact's
    batch size and input contract are the manifest's. Imports no model
    code."""
    from ..evaluation.export import load_exported

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    with open(path, "rb") as f:
        fn, _ = load_exported(f.read(), device=device)
    with open(path + ".json") as f:
        manifest = json.load(f)
    spec = {k: (tuple(v["shape"][1:]), v["dtype"])
            for k, v in manifest["input"].items()}
    return ServingModel(
        _host_outputs(fn), spec, manifest["batch_size"], manifest["output_modalities"],
        meta={"source": "artifact", "path": path, "platforms": list(manifest["platforms"]),
              "backend": "torch", "device": str(device)},
    )


def load_live(run_dir: str, batch_size: int, device="cuda", which: str = "best",
              lc_len: Optional[int] = None, sp_len: Optional[int] = None,
              image_size: Optional[int] = None) -> ServingModel:
    """Serve straight from a run directory (``model_config.json`` + a
    reference-layout ``.ckpt``) on ``device``. Each size comes from its
    flag, else the sidecar's ``extra``, else the real-data serving default
    (100, 1000, 60), as in the JAX package.

    ``fn`` moves the numpy feed to ``device``, runs ``encode`` under
    ``torch.inference_mode()`` (inside ``fn``: the batcher calls it from its
    own thread and inference mode is thread-local) and returns host numpy
    arrays, which the batcher's fetcher needs (it calls ``np.asarray`` on
    each output). The copy back is synchronous."""
    from ..models.clip import MODALITIES, CLIPModel
    from ..models.factory import load_model

    device = torch.device(device)
    model, extra = load_model(run_dir, device, which=which)  # raises without CUDA
    if not isinstance(model, CLIPModel):
        raise ValueError(f"{run_dir} holds a {type(model).__name__}: load_live serves a "
                         "CLIPModel's embeddings")
    combos = model.cfg.combinations
    spec = input_spec(
        combos, int(extra.get("nband", model.cfg.nband)),
        lc_len or int(extra.get("max_lightcurve_data_len", 100)),
        sp_len or int(extra.get("max_spectral_data_len", 1000)),
        image_size or int(extra.get("image_size", 60)),
        int(model.cfg.ck().get("channels", 3)))

    def fn(feed: Dict[str, np.ndarray]) -> List[torch.Tensor]:
        with torch.inference_mode():
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in feed.items()}
            return model.encode(batch)

    return ServingModel(
        _host_outputs(fn), spec, batch_size, [m for m in MODALITIES if m in combos],
        meta={"source": "run_dir", "path": run_dir, "which": which,
              "backend": "torch", "device": str(device)},
    )


# --------------------------------------------------------------- wire I/O

def _read_npz(body: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _write_npz(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    # set on the server instance: .batcher, .model, .quiet
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        if not getattr(self.server, "quiet", True):
            super().log_message(fmt, *args)

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj):
        self._reply(code, (json.dumps(obj) + "\n").encode(),
                    "application/json")

    def do_GET(self):
        model: ServingModel = self.server.model
        if self.path == "/healthz":
            self._reply_json(200, {
                "status": "ok",
                "batch_size": model.batch_size,
                "max_wait_ms": self.server.batcher.max_wait_s * 1e3,
                "output_modalities": model.modalities,
                "input": {k: {"shape": ["n"] + list(s), "dtype": str(d)}
                          for k, (s, d) in model.input_spec.items()},
                **model.meta,
            })
        elif self.path == "/stats":
            self._reply_json(200, self.server.batcher.stats.snapshot())
        else:
            self._reply_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/embed":
            return self._reply_json(404, {"error": f"unknown path {self.path}"})
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            as_json = ctype == "application/json"
            if as_json:
                arrays = {k: np.asarray(v)
                          for k, v in json.loads(body.decode()).items()}
            else:
                arrays = _read_npz(body)
        except Exception as e:
            return self._reply_json(400, {"error": f"unreadable body: {e}"})
        try:
            outs = self.server.batcher.submit(arrays)
        except ValueError as e:  # contract violation
            return self._reply_json(400, {"error": str(e)})
        except RuntimeError as e:  # closed / device failure
            return self._reply_json(503, {"error": str(e)})
        named = {f"emb_{m}": o
                 for m, o in zip(self.server.model.modalities, outs)}
        if as_json:
            self._reply_json(200, {k: v.tolist() for k, v in named.items()})
        else:
            self._reply(200, _write_npz(named), "application/x-npz")


class EmbedServer:
    """Owns the HTTP server + batcher; usable in-process (tests) or from
    ``cli/serve.py``. Warms the model up (one device call) before it binds.
    ``port=0`` binds an ephemeral port (then read ``.port``)."""

    def __init__(self, model: ServingModel, host: str = "127.0.0.1",
                 port: int = 0, max_wait_ms: float = 5.0,
                 quiet: bool = True):
        model.warmup()
        self.model = model
        self.batcher = DynamicBatcher(
            model.fn, {k: (s, d) for k, (s, d) in model.input_spec.items()},
            model.batch_size, max_wait_ms=max_wait_ms)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.model = model
        self.httpd.batcher = self.batcher
        self.httpd.quiet = quiet
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start_background(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="mmsn-serving-http",
            daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
        if self._thread:
            self._thread.join(timeout=10)


def serve(model: ServingModel, host: str = "127.0.0.1", port: int = 8000,
          max_wait_ms: float = 5.0, quiet: bool = False) -> EmbedServer:
    """Blocking entry used by ``cli/serve.py``."""
    srv = EmbedServer(model, host=host, port=port, max_wait_ms=max_wait_ms,
                      quiet=quiet)
    print(json.dumps({"serving": True, "host": host, "port": srv.port,
                      "batch_size": model.batch_size,
                      "output_modalities": model.modalities,
                      **model.meta}), flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.close()
    return srv
