"""JAX parameters -> this package's state_dict (numpy only).

The lc/sp CLIP subset of ``multimodal_supernovae_tpu/models/torch_export.py``
(``_export_seq_encoder`` and ``export_reference_state_dict``): a flax
parameter tree, as nested dicts of arrays, becomes the reference-layout
state_dict that ``CLIPModel.load_state_dict(strict=True)`` takes. Dense
kernels (in, out) become Linear weights (out, in); the attention-pooling
q/k/v projections are packed into ``in_proj_weight``/``in_proj_bias``. It
is the weight bridge the port's tests hold against the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

__all__ = ["seq_encoder_state_dict", "state_dict_from_jax"]


def _w(kernel) -> np.ndarray:
    """flax Dense kernel (in, out) -> torch Linear weight (out, in)."""
    return np.ascontiguousarray(np.asarray(kernel, dtype=np.float32).T)


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _dense(sd, key: str, p: Dict[str, Any]):
    sd[key + ".weight"] = _w(p["kernel"])
    if "bias" in p:
        sd[key + ".bias"] = _a(p["bias"])


def seq_encoder_state_dict(p: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """SequenceEncoder params -> ``SequenceEncoder`` state_dict entries."""
    sd: Dict[str, np.ndarray] = {}
    _dense(sd, prefix + "embedding_mag", p["embedding_mag"])
    _dense(sd, prefix + "projection", p["projection"])
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


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX ``CLIPModel``'s params (lightcurve/spectral towers) -> the
    port's ``CLIPModel`` state_dict, as numpy arrays."""
    unported = sorted(set(params) & {"image_encoder", "class_emb", "linear",
                                     "clip_model", "net"})
    if unported:
        raise NotImplementedError(
            f"parameters {unported} belong to towers or heads the port does "
            "not have yet (ROADMAP.md queue 1, items 11-13)")
    sd: Dict[str, np.ndarray] = {
        "logit_scale": _a(params["logit_scale"]),
        "logit_bias": _a(params["logit_bias"]),
    }
    for tower in ("lightcurve", "spectral"):
        if f"{tower}_encoder" in params:
            sd.update(seq_encoder_state_dict(
                params[f"{tower}_encoder"], f"{tower}_encoder."))
            _dense(sd, f"{tower}_projection", params[f"{tower}_projection"])
    return sd
