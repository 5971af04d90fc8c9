"""Parameter partitioning over the model axis (port of
multimodal_supernovae_tpu/parallel/sharding.py).

The JAX package annotates placements and lets XLA insert the collectives;
the port swaps each split layer for one that holds its slice and makes its
own collectives (parallel/mesh.py). The rules are the JAX ``_spec_for``'s:
the wide matmuls, the transformer blocks' feed-forward expansion and the
ConvMixer head, take the Megatron COLUMN split (output dimension over
``model``) and their consumers the ROW split (input dimension), so the pair
needs one all-reduce; the split applies only where the width divides by
n_model, and the layer stays whole otherwise; a column-split layer's bias
is split with its output, a row-split layer's stays whole and is added once,
after the reduce. Every other parameter is whole on every rank.

The JAX layer names map to the port's through the key bridge
(models/convert.py): ``ff_in`` / ``ff_out`` are each ``TransformerBlock``'s
``ff.0`` / ``ff.2``, ``head_fc1`` / ``head_fc2`` the ConvMixer's
``projection.2`` / ``projection.5``. A torch ``Linear`` weight is (out, in),
the transpose of a flax kernel: the column split is its dimension 0, the row
split its dimension 1.

  * ``spec_for(name, tensor, n_model)``: the dimension of a state_dict entry
    that splits (None: whole);
  * ``shard_module(model, mesh)``: every split pair of ``model`` becomes a
    ``ColumnParallelDense`` / ``RowParallelDense`` holding this model rank's
    slice of the full weights, which every rank builds from the shared seed;
  * ``gather_state_dict`` / ``shard_state_dict``: the full reference-layout
    state_dict from the slices (an all-gather over the model group), and
    this rank's slices of a full one; the ``*_optimizer_state`` pair does
    the same for an optimizer's moments.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import torch
from torch import nn

_COL_SPLIT = ("ff_in", "head_fc1")
_ROW_SPLIT = ("ff_out", "head_fc2")
# the key bridge: the port's layer path -> the JAX layer name
_BRIDGE = ((re.compile(r"(?:^|\.)ff\.0$"), "ff_in"), (re.compile(r"(?:^|\.)ff\.2$"), "ff_out"),
           (re.compile(r"(?:^|\.)projection\.2$"), "head_fc1"),
           (re.compile(r"(?:^|\.)projection\.5$"), "head_fc2"))


def _jax_layer(module_path: str) -> Optional[str]:
    """The JAX layer name of a port module path, where the split rules name it."""
    for pattern, name in _BRIDGE:
        if pattern.search(module_path):
            return name
    return None


def spec_for(name: str, tensor: torch.Tensor, n_model: int) -> Optional[int]:
    """The torch dimension of state_dict entry ``name`` that splits over a
    model axis of ``n_model``, or None (whole): JAX ``_spec_for``'s rules."""
    module_path, _, _ = name.rpartition(".")
    layer = _jax_layer(module_path)
    if n_model <= 1 or layer is None:
        return None
    if tensor.dim() == 2:
        if layer in _COL_SPLIT and tensor.shape[0] % n_model == 0:
            return 0
        if layer in _ROW_SPLIT and tensor.shape[1] % n_model == 0:
            return 1
    if tensor.dim() == 1 and layer in _COL_SPLIT and tensor.shape[0] % n_model == 0:
        return 0
    return None


def _pairs(model: nn.Module):
    """(path, container, column index, row index) of every split pair."""
    from ..models.convmixer import ConvMixer
    from ..models.transformer import TransformerBlock

    for path, m in model.named_modules():
        prefix = f"{path}." if path else ""
        if isinstance(m, TransformerBlock):
            yield f"{prefix}ff", m.ff, 0, 2
        elif isinstance(m, ConvMixer):
            yield f"{prefix}projection", m.projection, 2, 5


def shard_module(model: nn.Module, mesh) -> nn.Module:
    """Swap, in place, every split pair of ``model`` (each transformer
    block's FFN, the ConvMixer head) for its column- and row-parallel
    counterparts over ``mesh``'s model axis; a pair whose width the axis
    does not divide stays whole, and a pair already split over ``mesh`` is
    left as it is (a pair split over another mesh raises). Returns
    ``model``."""
    from ..models.transformer import ColumnParallelDense, RowParallelDense

    n = mesh.n_model
    for path, seq, i, j in list(_pairs(model)):
        if isinstance(seq[i], ColumnParallelDense) or isinstance(seq[j], RowParallelDense):
            if not all(isinstance(m, t) and m.mesh == mesh for m, t in (
                    (seq[i], ColumnParallelDense), (seq[j], RowParallelDense))):
                raise ValueError(f"{path} is already split over another mesh")
            continue
        if n <= 1:
            continue
        col = spec_for(f"{path}.{i}.weight", seq[i].weight, n)
        row = spec_for(f"{path}.{j}.weight", seq[j].weight, n)
        if (col, row) == (0, 1):
            seq[i] = ColumnParallelDense(seq[i], mesh)
            seq[j] = RowParallelDense(seq[j], mesh)
        elif (col, row) != (None, None):
            raise ValueError(f"{path}: the column split {col} and the row split {row} of one "
                             "pair disagree")
    return model


def split_dims(model: nn.Module) -> Dict[str, int]:
    """{state_dict name: split dimension} of ``model``'s split tensors."""
    from ..models.transformer import ColumnParallelDense, RowParallelDense

    out = {}
    for path, m in model.named_modules():
        if isinstance(m, (ColumnParallelDense, RowParallelDense)):
            out.update({f"{path}.{k}": d for k, d in m.split.items()})
    return out


def _mesh_of(model: nn.Module):
    from ..models.transformer import ColumnParallelDense

    return next((m.mesh for m in model.modules() if isinstance(m, ColumnParallelDense)), None)


def _gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    from .mesh import _gather as gather

    return gather(x.detach(), mesh.n_model, mesh.model_group, dim)


def _narrow(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    c = x.shape[dim] // mesh.n_model
    return x.narrow(dim, mesh.model_rank * c, c)


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s full reference-layout state_dict: its names and shapes
    are the one-process model's. A collective over the model group: every
    rank of it must call."""
    sd, dims = model.state_dict(), split_dims(model)
    if not dims:
        return sd
    mesh = _mesh_of(model)
    return {k: _gather(v, mesh, dims[k]) if k in dims else v for k, v in sd.items()}


def shard_state_dict(sd: Dict[str, torch.Tensor], model: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """This model rank's slices of a full state_dict, for ``model``."""
    dims = split_dims(model)
    if not dims:
        return sd
    mesh = _mesh_of(model)
    return {k: _narrow(v, mesh, dims[k]) if k in dims else v for k, v in sd.items()}


def _state_dims(optimizer: torch.optim.Optimizer, model: nn.Module) -> Dict[int, int]:
    """{optimizer state index: split dimension}: torch numbers the
    parameters in the order of its groups."""
    dims = split_dims(model)
    names = {id(p): n for n, p in model.named_parameters()}
    out, i = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            d = dims.get(names.get(id(p)))
            if d is not None:
                out[i] = d
            i += 1
    return out


def _map_moments(opt_sd: Dict[str, Any], dims: Dict[int, int], fn) -> Dict[str, Any]:
    state = {}
    for i, st in opt_sd["state"].items():
        d = dims.get(int(i))
        state[i] = st if d is None else {
            k: fn(v, d) if torch.is_tensor(v) and v.dim() > 0 else v for k, v in st.items()}
    return dict(opt_sd, state=state)


def gather_optimizer_state(optimizer: torch.optim.Optimizer, model: nn.Module
                           ) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with each split parameter's moments
    gathered whole (a collective over the model group)."""
    opt_sd = optimizer.state_dict()
    mesh = _mesh_of(model)
    if mesh is None:
        return opt_sd
    return _map_moments(opt_sd, _state_dims(optimizer, model),
                        lambda v, d: _gather(v, mesh, d))


def shard_optimizer_state(opt_sd: Dict[str, Any], optimizer: torch.optim.Optimizer,
                          model: nn.Module) -> Dict[str, Any]:
    """This model rank's slices of a full optimizer state_dict."""
    mesh = _mesh_of(model)
    if mesh is None:
        return opt_sd
    return _map_moments(opt_sd, _state_dims(optimizer, model),
                        lambda v, d: _narrow(v, mesh, d))
