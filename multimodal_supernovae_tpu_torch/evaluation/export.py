"""Ahead-of-time export of the frozen encoder for serving (port of
multimodal_supernovae_tpu/evaluation/export.py), through ``torch.export``.

``export_encoder`` traces ``CLIPModel.encode`` with the weights baked in and
returns the bytes of ``torch.export.save``: the graph of aten ops and the
port's registered kernel ops, its parameters and buffers, and the pytree of
its input and output. ``load_exported`` rebuilds a callable from the bytes
without this package's model code: it imports only ``ops``, whose modules
register the three ops an artifact may hold (``mmsn_torch::
flash_attention_fwd``, ``fused_ffn_block_fwd`` and ``fused_qkv_attention_fwd``),
so a serving host needs no ``CLIPModel`` and no checkpoint.

The dispatch is resolved when the encoder is traced, as in the JAX package:
an encoder exported from the card holds one op node for every forward kernel
its live call launches (the flash forward in each attention layer, and the
fused block or the fused QKV attention under ``MMSN_FUSED_BLOCK=1`` /
``MMSN_FUSED_QKV=1``), and each node picks its route and launches inside the
op's body at call time, from the real tensors, exactly as the live call
does; those ops have no CPU implementation, so such an artifact runs on the
card or raises. An encoder exported from the CPU holds the plain versions
as aten ops and is loaded on the CPU only: ``load_exported`` refuses to run
an artifact on a device type other than its own.

Notes, as in the JAX package:
  * The batch dimension is FIXED per artifact (static shapes); a call at
    another batch size, or with a field the contract does not name, raises.
  * The artifact takes ONE argument, a plain dict of the fields ``encode``
    reads (``batch_to_dict(batch, combinations)``), numpy arrays or tensors,
    and returns the tuple of L2-normalised embeddings in canonical order.
  * The trace runs under ``torch.no_grad()``: an ``inference_mode`` tensor
    cannot be traced, and without a gradient to take each kernel's forward
    runs alone.
"""

from __future__ import annotations

import io
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..data.batching import BATCH_FIELDS

# models/clip.py's canonical tower order, kept here so that loading an
# artifact imports no model code
MODALITIES = ("host_galaxy", "lightcurve", "spectral", "meta")

# Batch fields CLIPModel.encode reads per modality. err_lc/err_sp are
# augmentation-only and redshift/label are meta-tower inputs: none belong in
# a serving contract unless the model uses them.
ENCODE_FIELDS = {
    "host_galaxy": ("x_img",),
    "lightcurve": ("x_lc", "t_lc", "mask_lc"),
    "spectral": ("x_sp", "t_sp", "mask_sp"),
    "meta": ("label", "redshift"),
}


def encode_input_fields(combinations) -> Tuple[str, ...]:
    """The exact batch fields ``encode`` reads for these modalities."""
    out = []
    for m in MODALITIES:
        if m in combinations:
            out.extend(ENCODE_FIELDS[m])
    return tuple(out)


def batch_to_dict(batch: Mapping, combinations=None) -> Dict:
    """The artifact's input format: a PLAIN dict of the present (non-None)
    batch fields, in ``BATCH_FIELDS`` order. With ``combinations`` it keeps
    only the fields ``encode`` reads for those modalities, so the serving
    contract carries no training-only arrays (err_lc/err_sp, an unused
    redshift/label)."""
    keep = None if combinations is None else set(encode_input_fields(combinations))
    return {k: batch[k] for k in BATCH_FIELDS
            if batch.get(k) is not None and (keep is None or k in keep)}


def modality_names(model) -> List[str]:
    """Output-embedding order: the canonical order ``encode`` uses."""
    return [m for m in MODALITIES if m in model.cfg.combinations]


class _Encode(torch.nn.Module):
    """``model.encode`` over one dict, as the traced function."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, d: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return tuple(self.model.encode(d))


def export_encoder(model, example: Mapping) -> bytes:
    """Serialize ``model.encode`` with its weights baked in.

    ``example``: a batch dict on the model's device at the artifact's batch
    size; the artifact's input is ``batch_to_dict(example,
    model.cfg.combinations)``, its exact shapes and dtypes. Returns the bytes
    of ``torch.export.save``."""
    d = batch_to_dict(example, model.cfg.combinations)
    with torch.no_grad():
        exported = torch.export.export(_Encode(model), (d,), strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_exported(data: bytes, device=None):
    """Rebuild a callable from ``export_encoder`` bytes.

    Returns (fn, exported): ``fn(d) -> embeddings tuple`` takes a dict of
    numpy arrays or tensors, moves them to the artifact's device and runs the
    graph under ``torch.inference_mode()``; ``exported`` is the
    ``torch.export.ExportedProgram`` (its graph, signature and weights).
    The artifact runs where it was exported; ``device``, if given, must be
    of that type (an artifact exported on the card holds the kernels, one
    exported on the CPU the plain versions, and neither runs as the
    other)."""
    # the three kernel ops must be registered before the graph is rebuilt
    from ..ops import flash_attention, fused_block, qkv_attention  # noqa: F401

    exported = torch.export.load(io.BytesIO(data))
    target = _device_of(exported)
    if device is not None and torch.device(device).type != target.type:
        raise ValueError(f"the artifact was exported on {target.type}, not "
                         f"{torch.device(device).type}: export it there to run it there")
    module = serving_module(exported)

    def fn(d: Mapping) -> Tuple[torch.Tensor, ...]:
        with torch.inference_mode():
            return tuple(module({k: _tensor(v).to(target) for k, v in d.items()}))

    return fn, exported


def serving_module(exported) -> torch.nn.Module:
    """``exported.module()`` without its ``aten._assert_tensor_metadata``
    nodes. ``torch.export`` adds one after every ``.to(dtype)`` of the
    traced encoder (433 of a bf16 maven-lite graph's 1,847 nodes), each an
    op call on the host at every call that checks a dtype the inputs'
    own check (the module's pre-hook: shapes and dtypes against the
    artifact's) already fixes."""
    module = exported.module()
    graph = module.graph
    for node in list(graph.nodes):
        if node.op == "call_function" and \
                node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    module.recompile()
    return module


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    a = np.ascontiguousarray(v)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _device_of(exported) -> torch.device:
    """The device an exported encoder's weights lie on."""
    tensors = list(exported.state_dict.values()) + [
        c for c in exported.constants.values() if isinstance(c, torch.Tensor)]
    return tensors[0].device if tensors else torch.device("cpu")


def kernel_ops(exported) -> Dict[str, int]:
    """{op name: node count} of the port's kernel ops (namespace
    ``mmsn_torch``) in an exported graph."""
    counts: Dict[str, int] = {}
    for node in exported.graph.nodes:
        name = str(node.target) if node.op == "call_function" else ""
        if name.startswith("mmsn_torch."):
            op = name.split(".")[1]
            counts[op] = counts.get(op, 0) + 1
    return counts


__all__ = ["ENCODE_FIELDS", "MODALITIES", "batch_to_dict",
           "encode_input_fields", "export_encoder", "kernel_ops", "load_exported",
           "modality_names", "serving_module"]
