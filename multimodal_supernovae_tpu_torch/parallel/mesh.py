"""The device mesh (port of multimodal_supernovae_tpu/parallel/mesh.py).

The JAX package parallelises over a 2-D ``(data, model)`` device mesh; the
port runs one process a card, joined in a ``torch.distributed`` process
group (``parallel/distributed.py``), and lays the ranks out as that mesh
with the model axis innermost: rank = d * n_model + m.

  * ``data``: each data rank trains on its block of the global batch's
    rows; the contrastive embeddings, the supervised predictions and the
    masked reconstructions are all-gathered over the DATA GROUP (the ranks
    that share m), so that every loss spans the global batch, the image
    tower's BatchNorm takes the global batch's statistics over it, and the
    gradients are averaged over it.
  * ``model``: tensor parallelism (parallel/sharding.py). The ranks of one
    MODEL GROUP (those that share d) hold the same rows and split the wide
    matmuls, the Megatron column split (``ff_in``, ``head_fc1``) and row
    split (``ff_out``, ``head_fc2``). Two autograd Functions carry it:
    ``copy_to_model`` at a column-split layer's input (the identity
    forward, an all-reduce of the gradient over the model group backward)
    and ``reduce_from_model`` at a row-split layer's output (an all-reduce
    forward, the identity backward). After the reduce every model rank
    computes the same downstream loss, so its backward must NOT all-reduce
    again (``_AllReduce`` below does, which is right for BatchNorm's sums
    and would scale every upstream gradient by n_model here).
    ``gather_from_model`` all-gathers a split tensor (the fused block's
    FFN weights); its backward keeps this rank's slice of the gradient,
    with no reduction, since every model rank already holds the whole
    gradient of its data group's rows.

Every collective is built on ``all_gather`` and ``all_reduce`` alone, which
NCCL and gloo both offer for CUDA tensors (torch's own differentiable
all-gather takes its backward through ``all_to_all``, which gloo lacks for
CUDA tensors; gloo's ``all_gather`` and ``all_reduce`` took CUDA tensors on
an H100 with torch 2.11):

  * ``all_gather``: (b, ...) on each data rank -> (n b, ...) in rank order,
    so positive pairs stay on the diagonal; its backward all-reduces the
    gathered gradient and keeps this rank's rows;
  * ``all_reduce``: the sum over the data ranks; its backward is the sum too.

Every data rank computes the same global loss L, so the backward of the
gather hands each rank n dL/de for its rows; the mean over the data group
in ``average_gradients`` brings every tower parameter back to dL/dtheta,
while a parameter used after the gather (the logit scale and bias) gets
dL/ds on every rank and keeps it. Scaling the loss by n instead would leave
the towers right and the scale and bias n times too large. A model-split
parameter keeps its own shard's gradient, averaged over the data group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Sequence

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _dist():
    import torch.distributed as dist

    return dist


def _gather(x: torch.Tensor, n: int, group, dim: int = 0) -> torch.Tensor:
    dist = _dist()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    _dist().all_reduce(y, group=group)
    return y


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(x, mesh.size, mesh.group)

    @staticmethod
    def backward(ctx, g):
        g = _summed(g, ctx.mesh.group)
        return g[ctx.mesh.block(g.shape[0])], None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _summed(x, mesh.group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh.group), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _summed(x, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.width = mesh, dim, x.shape[dim]
        return _gather(x, mesh.n_model, mesh.model_group, dim)

    @staticmethod
    def backward(ctx, g):
        m, c = ctx.mesh.model_rank, ctx.width
        return g.narrow(ctx.dim, m * c, c).contiguous(), None, None


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """This process's place on the ``(data, model)`` mesh: global ``rank``
    (= data_rank * n_model + model_rank), ``size`` the data axis's size,
    ``n_model`` the model axis's, its ``device``, the data ``group`` (the
    ranks that share this model rank) and the ``model_group`` (the ranks
    that share this data rank). A group is None where its axis has one
    rank: every collective over it is then the identity, and a mesh
    without either group is one process."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None
    n_model: int = 1
    model_group: Any = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> Dict[str, int]:
        """The JAX ``Mesh.shape``: {'data': n_data, 'model': n_model}."""
        return {DATA_AXIS: self.size, MODEL_AXIS: self.n_model}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def joined(self) -> bool:
        """Whether the mesh spans more than this process."""
        return self.group is not None or self.model_group is not None

    @property
    def backend(self) -> Optional[str]:
        return _dist().get_backend() if self.joined else None

    def local(self, n: int) -> int:
        """This data rank's share of a global dimension of ``n``; raises
        unless the data ranks divide it (the JAX sharding's rule)."""
        if n % self.size:
            raise ValueError(f"global batch {n} is not divisible by the data mesh "
                             f"axis ({self.size})")
        return n // self.size

    def block(self, n: int) -> slice:
        """This data rank's rows of a global dimension of ``n``."""
        b = self.local(n)
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(b, ...) on every data rank -> (size * b, ...) in rank order;
        differentiable."""
        return x if self.group is None else _AllGather.apply(x, self)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data ranks; differentiable."""
        return x if self.group is None else _AllReduce.apply(x, self)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """A column-split layer's input: ``x`` forward, the sum of the model
        ranks' gradients backward."""
        return x if self.model_group is None else _CopyToModel.apply(x, self)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """A row-split layer's output: the sum of the model ranks' partial
        products forward, the gradient as it is backward."""
        return x if self.model_group is None else _ReduceFromModel.apply(x, self)

    def gather_from_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model ranks' slices of a split tensor joined along ``dim``;
        backward, this rank's slice of the gradient (no reduction)."""
        return x if self.model_group is None else _GatherFromModel.apply(x, self, dim)

    def average_gradients(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Every gradient becomes its mean over the data ranks, through one
        flattened all-reduce a dtype. A parameter without a gradient (one
        the loss does not reach) keeps None, as on one process, so the
        optimizer skips it."""
        if self.group is None:
            return
        by_dtype: Dict[torch.dtype, list] = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            _dist().all_reduce(flat, group=self.group)
            flat /= self.size
            parts = flat.split([g.numel() for g in grads])
            torch._foreach_copy_(grads, [p.view_as(g) for p, g in zip(parts, grads)])

    def gather_objects(self, obj: Any) -> list:
        """``obj`` of every data rank, in data-rank order (host objects)."""
        if self.group is None:
            return [obj]
        out = [None] * self.size
        _dist().all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        """Every rank of the mesh (both axes) waits for the others."""
        if self.joined:
            dist = _dist()
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index or 0])
            else:
                dist.barrier()


def _groups(n_data: int, n_model: int, rank: int):
    """(data group, model group) of ``rank``. Every process makes every
    group, in one order, as ``new_group`` requires."""
    dist = _dist()
    world = dist.group.WORLD
    if n_model == 1:  # a one-rank group too, as a torchrun launch of one process makes
        return world, None
    if n_data == 1:
        return None, world
    data = [dist.new_group([d * n_model + m for d in range(n_data)]) for m in range(n_model)]
    model = [dist.new_group([d * n_model + m for m in range(n_model)]) for d in range(n_data)]
    return data[rank % n_model], model[rank // n_model]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: Optional[torch.device] = None) -> DataMesh:
    """The ``(data, model)`` mesh over the process group this process has
    joined (``parallel.distributed.initialize``), or a one-process mesh
    without one: the model axis innermost, as the JAX ``make_mesh`` lays it
    out. ``n_data=None`` takes every process the model axis leaves; the
    mesh must cover the group's processes exactly (one process a rank)."""
    dist = _dist()
    joined = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if joined else (1, 0)
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} devices not divisible by model axis {n_model}")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model > world:
        raise ValueError(f"mesh {n_data}x{n_model} exceeds {world} devices (each rank of "
                         "the mesh is one process: launch with torchrun --nproc-per-node "
                         f"{n_data * n_model})")
    if n_data * n_model < world:
        raise ValueError(f"mesh {n_data}x{n_model} leaves {world - n_data * n_model} of the "
                         f"group's {world} processes off the mesh (one process a rank)")
    if not joined:
        return DataMesh(0, 1, torch.device(device or "cpu"))
    from . import distributed

    group, model_group = _groups(n_data, n_model, rank)
    return DataMesh(rank, n_data, torch.device(device or distributed.local_device()), group,
                    n_model, model_group)


def batch_stats_over(model: torch.nn.Module, mesh: Optional[DataMesh]):
    """A context in which every BatchNorm of ``model`` (models/convmixer.py)
    takes its train-mode statistics over ``mesh``'s global batch: an
    all-reduce over the data group, never the whole world, which would count
    each row n_model times."""
    import contextlib

    from ..models.convmixer import BatchNorm

    @contextlib.contextmanager
    def ctx():
        norms: Sequence[BatchNorm] = [m for m in model.modules() if isinstance(m, BatchNorm)]
        saved = [m.mesh for m in norms]
        for m in norms:
            m.mesh = mesh
        try:
            yield
        finally:
            for m, s in zip(norms, saved):
                m.mesh = s

    return ctx()
