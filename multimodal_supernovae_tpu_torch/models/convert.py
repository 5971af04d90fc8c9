"""JAX parameters -> this package's state_dict (numpy only).

A copy of ``multimodal_supernovae_tpu/models/torch_export.py``
(``_export_seq_encoder``, ``_export_convmixer``, ``_export_mlp`` and
``export_reference_state_dict``) for the three model families, and, beyond
it, the ViT image tower (``vit_state_dict``; the JAX exporter refuses a
ViT, so this is its only bridge): a flax
parameter tree (and, for a ConvMixer, its ``batch_stats`` collection), as
nested dicts of arrays, becomes the reference-layout state_dict that the
port's ``CLIPModel``, ``MaskedLightCurveEncoder`` (``net.*`` and
``last_layer.*``) or ``ClipMLPHead`` (``clip_model.*`` and ``mlp_model.*``)
takes with ``load_state_dict(strict=True)``. Dense kernels (in, out)
become Linear weights (out, in); conv kernels (kh, kw, in / groups, out)
become (out, in / groups, kh, kw), a depthwise (k, k, 1, C) one (C, 1, k,
k); the attention-pooling q/k/v projections are packed into
``in_proj_weight``/``in_proj_bias``. It is the weight bridge the port's
tests hold against the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

__all__ = ["convmixer_state_dict", "mlp_state_dict", "seq_encoder_state_dict",
           "state_dict_from_jax", "vit_state_dict"]


def _w(kernel) -> np.ndarray:
    """flax Dense kernel (in, out) -> torch Linear weight (out, in)."""
    return np.ascontiguousarray(np.asarray(kernel, dtype=np.float32).T)


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _dense(sd, key: str, p: Dict[str, Any]):
    sd[key + ".weight"] = _w(p["kernel"])
    if "bias" in p:
        sd[key + ".bias"] = _a(p["bias"])


def seq_encoder_state_dict(p: Dict[str, Any], prefix: str = "",
                           n_out: Optional[int] = None) -> Dict[str, np.ndarray]:
    """SequenceEncoder params -> ``SequenceEncoder`` state_dict entries. A
    pretraining tower has no ``projection``; its dead keys are written as
    zeros of shape (n_out, emb), as the JAX exporter writes them, and then
    ``n_out`` must be given."""
    sd: Dict[str, np.ndarray] = {}
    _dense(sd, prefix + "embedding_mag", p["embedding_mag"])
    if "projection" in p:
        _dense(sd, prefix + "projection", p["projection"])
    else:
        if n_out is None:
            raise ValueError(f"{prefix}: the params carry no projection (a pretraining "
                             "tower); pass n_out for its zero keys")
        emb = np.asarray(p["embedding_mag"]["kernel"]).shape[1]
        sd[prefix + "projection.weight"] = np.zeros((int(n_out), emb), np.float32)
        sd[prefix + "projection.bias"] = np.zeros(int(n_out), np.float32)
    if "band_emb" in p:
        sd[prefix + "band_emb.weight"] = _a(p["band_emb"]["embedding"])
    i = 0
    while f"block_{i}" in p["transformer"]:
        blk = p["transformer"][f"block_{i}"]
        b = f"{prefix}transformer.tblocks.{i}."
        for name in ("tokeys", "toqueries", "tovalues", "unifyheads"):
            _dense(sd, b + "attention." + name, blk["attention"][name])
        for name in ("norm1", "norm2"):
            sd[b + name + ".weight"] = _a(blk[name]["scale"])
            sd[b + name + ".bias"] = _a(blk[name]["bias"])
        _dense(sd, b + "ff.0", blk["ff_in"])
        _dense(sd, b + "ff.2", blk["ff_out"])
        i += 1
    if "query" in p:
        agg = p["agg_attn"]
        sd[prefix + "query"] = _a(p["query"])
        sd[prefix + "agg_attn.in_proj_weight"] = np.concatenate(
            [_w(agg[n]["kernel"]) for n in ("q_proj", "k_proj", "v_proj")], axis=0)
        sd[prefix + "agg_attn.in_proj_bias"] = np.concatenate(
            [_a(agg[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")], axis=0)
        _dense(sd, prefix + "agg_attn.out_proj", agg["out_proj"])
    return sd


def _conv_w(kernel) -> np.ndarray:
    """flax conv kernel (kh, kw, in / groups, out) -> torch (out, in / groups,
    kh, kw)."""
    return np.ascontiguousarray(np.asarray(kernel, dtype=np.float32).transpose(3, 2, 0, 1))


def convmixer_state_dict(p: Dict[str, Any], stats: Dict[str, Any],
                         prefix: str = "") -> Dict[str, np.ndarray]:
    """ConvMixer params and batch_stats -> ``ConvMixer`` state_dict entries.
    ``num_batches_tracked``, a torch buffer with no flax counterpart, is 0,
    as the JAX exporter writes it."""
    sd: Dict[str, np.ndarray] = {}

    def bn(ours: str, key: str):
        sd[key + ".weight"] = _a(p[ours]["scale"])
        sd[key + ".bias"] = _a(p[ours]["bias"])
        sd[key + ".running_mean"] = _a(stats[ours]["mean"])
        sd[key + ".running_var"] = _a(stats[ours]["var"])
        sd[key + ".num_batches_tracked"] = np.asarray(0, dtype=np.int64)

    sd[prefix + "net.0.weight"] = _conv_w(p["patch_embed"]["kernel"])
    bn("patch_bn", prefix + "net.2")
    i = 0
    while f"dw_conv_{i}" in p:
        blk = f"{prefix}net.{3 + i}"
        sd[blk + ".0.fn.0.weight"] = _conv_w(p[f"dw_conv_{i}"]["kernel"])
        sd[blk + ".0.fn.0.bias"] = _a(p[f"dw_conv_{i}"]["bias"])
        bn(f"dw_bn_{i}", blk + ".0.fn.2")
        sd[blk + ".1.weight"] = _conv_w(p[f"pw_conv_{i}"]["kernel"])
        sd[blk + ".1.bias"] = _a(p[f"pw_conv_{i}"]["bias"])
        bn(f"pw_bn_{i}", blk + ".3")
        i += 1
    _dense(sd, prefix + "projection.2", p["head_fc1"])
    _dense(sd, prefix + "projection.5", p["head_fc2"])
    return sd


def vit_state_dict(p: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """ViT params -> ``ViT`` state_dict entries (models/vit.py keeps the flax
    names; LayerNorm ``scale`` becomes ``weight``)."""
    sd: Dict[str, np.ndarray] = {}

    def norm(key: str, q: Dict[str, Any]):
        sd[key + ".weight"] = _a(q["scale"])
        sd[key + ".bias"] = _a(q["bias"])

    _dense(sd, prefix + "patch_embed", p["patch_embed"])
    sd[prefix + "pos_emb"] = _a(p["pos_emb"])
    i = 0
    while f"block_{i}" in p:
        blk, b = p[f"block_{i}"], f"{prefix}block_{i}."
        for name in ("toqueries", "tokeys", "tovalues", "unifyheads", "mlp_in", "mlp_out"):
            _dense(sd, b + name, blk[name])
        norm(b + "norm1", blk["norm1"])
        norm(b + "norm2", blk["norm2"])
        i += 1
    norm(prefix + "norm_out", p["norm_out"])
    _dense(sd, prefix + "head", p["head"])
    return sd


def mlp_state_dict(p: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """MLP params (hidden_0 .. hidden_{n-1}, out) -> ``MLP`` state_dict
    entries (Linears at layers.0, 3, 6, ..., the head last)."""
    sd: Dict[str, np.ndarray] = {}
    n = 0
    while f"hidden_{n}" in p:
        _dense(sd, f"{prefix}layers.{3 * n}", p[f"hidden_{n}"])
        n += 1
    _dense(sd, f"{prefix}layers.{3 * n}", p["out"])
    return sd


def state_dict_from_jax(params: Dict[str, Any],
                        batch_stats: Optional[Dict[str, Any]] = None,
                        n_out: Optional[int] = None) -> Dict[str, np.ndarray]:
    """A JAX model's params (and ``batch_stats``, which a ConvMixer image
    tower needs) -> the port's state_dict of the same family, as numpy
    arrays: a ``CLIPModel``; a ``MaskedLightCurveEncoder`` (a ``net``
    tree), whose dead projection keys take ``n_out`` (its config's,
    ``transformer_kwargs["n_out"]``); a ``ClipMLPHead`` (a ``clip_model``
    tree, its statistics under ``batch_stats["clip_model"]``)."""
    if "clip_model" in params:
        sd = {"clip_model." + k: v for k, v in state_dict_from_jax(
            params["clip_model"], (batch_stats or {}).get("clip_model")).items()}
        sd.update(mlp_state_dict(params["mlp_model"], "mlp_model."))
        return sd
    if "net" in params:
        sd = seq_encoder_state_dict(params["net"], "net.", n_out=n_out)
        _dense(sd, "last_layer", params["last_layer"])
        return sd
    sd: Dict[str, np.ndarray] = {
        "logit_scale": _a(params["logit_scale"]),
        "logit_bias": _a(params["logit_bias"]),
    }
    if "image_encoder" in params:
        if "patch_bn" not in params["image_encoder"]:  # a ViT: no batch statistics
            sd.update(vit_state_dict(params["image_encoder"], "image_encoder."))
        else:
            stats = (batch_stats or {}).get("image_encoder")
            if stats is None:
                raise ValueError("a ConvMixer image tower needs the batch_stats "
                                 "collection (BatchNorm running statistics)")
            sd.update(convmixer_state_dict(params["image_encoder"], stats, "image_encoder."))
        _dense(sd, "image_projection", params["image_projection"])
    for tower in ("lightcurve", "spectral"):
        if f"{tower}_encoder" in params:
            sd.update(seq_encoder_state_dict(
                params[f"{tower}_encoder"], f"{tower}_encoder."))
            _dense(sd, f"{tower}_projection", params[f"{tower}_projection"])
    if "class_emb" in params:
        sd["class_emb.weight"] = _a(params["class_emb"]["embedding"])
        sd.update(mlp_state_dict(params["meta_encoder"], "meta_encoder."))
    if "linear" in params:
        _dense(sd, "linear", params["linear"])
    return sd
