"""The data mesh (port of multimodal_supernovae_tpu/parallel/mesh.py).

The JAX package parallelises over a 2-D ``(data, model)`` device mesh. The
port has the ``data`` axis: one process a card, joined in a
``torch.distributed`` process group (``parallel/distributed.py``). Each
rank trains on its block of the global batch's rows; the contrastive
embeddings, the supervised predictions and the masked reconstructions are
all-gathered so that every loss spans the global batch, the image tower's
BatchNorm takes the global batch's statistics, and the gradients are
averaged over the ranks. The ``model`` axis (tensor parallelism) is not
ported: a model axis above 1 raises, naming ROADMAP.md item 15d.

Both collectives that carry gradients are autograd Functions built on
``all_gather`` and ``all_reduce`` alone, which NCCL and gloo both offer
for CUDA tensors (torch's own differentiable all-gather takes its backward
through ``all_to_all``, which gloo lacks for CUDA tensors; gloo's
``all_gather`` and ``all_reduce`` took CUDA tensors on an H100 with torch
2.11):

  * ``all_gather``: (b, ...) on each rank -> (n b, ...) in rank order, so
    positive pairs stay on the diagonal; its backward all-reduces the
    gathered gradient and keeps this rank's rows;
  * ``all_reduce``: the sum over ranks; its backward is the sum too.

Every rank computes the same global loss L, so the backward of the gather
hands each rank n dL/de for its rows; the mean over ranks in
``average_gradients`` brings every tower parameter back to dL/dtheta, while
a parameter used after the gather (the logit scale and bias) gets dL/ds on
every rank and keeps it. Scaling the loss by n instead would leave the
towers right and the scale and bias n times too large.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Sequence

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
TP_REFUSAL = ("tensor parallelism (a model axis above 1) is not ported yet "
              "(ROADMAP.md queue 1, item 15d)")


def _dist():
    import torch.distributed as dist

    return dist


def _gather(mesh: "DataMesh", x: torch.Tensor) -> torch.Tensor:
    dist = _dist()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(mesh, x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _dist().all_reduce(g, group=ctx.mesh.group)
        return g[ctx.mesh.block(g.shape[0])], None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.contiguous().clone()
        _dist().all_reduce(y, group=mesh.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _dist().all_reduce(g, group=ctx.mesh.group)
        return g, None


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """This process's place on the data axis: ``rank`` of ``size``, its
    ``device`` and the process ``group`` (None: no process group, one
    process, and every collective is the identity)."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        """The JAX ``Mesh.shape``: {'data': n, 'model': 1}."""
        return {DATA_AXIS: self.size, MODEL_AXIS: 1}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else _dist().get_backend(self.group)

    def local(self, n: int) -> int:
        """This rank's share of a global dimension of ``n``; raises unless
        the ranks divide it (the JAX sharding's rule)."""
        if n % self.size:
            raise ValueError(f"global batch {n} is not divisible by the data mesh "
                             f"axis ({self.size})")
        return n // self.size

    def block(self, n: int) -> slice:
        """This rank's rows of a global dimension of ``n``."""
        b = self.local(n)
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(b, ...) on every rank -> (size * b, ...) in rank order;
        differentiable."""
        return x if self.group is None else _AllGather.apply(x, self)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks; differentiable."""
        return x if self.group is None else _AllReduce.apply(x, self)

    def average_gradients(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Every gradient becomes its mean over the ranks, through one
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

    def barrier(self) -> None:
        if self.group is not None:
            dist = _dist()
            if self.backend == "nccl":
                dist.barrier(group=self.group, device_ids=[self.device.index or 0])
            else:
                dist.barrier(group=self.group)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: Optional[torch.device] = None) -> DataMesh:
    """The data mesh over the process group this process has joined
    (``parallel.distributed.initialize``), or a one-process mesh without
    one. ``n_data`` may only restate the group's size; ``n_model`` above 1
    raises (item 15d)."""
    if n_model != 1:
        raise NotImplementedError(TP_REFUSAL)
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        from . import distributed

        mesh = DataMesh(dist.get_rank(), dist.get_world_size(),
                        torch.device(device or distributed.local_device()),
                        dist.group.WORLD)
    else:
        mesh = DataMesh(0, 1, torch.device(device or "cpu"))
    if n_data is not None and n_data != mesh.size:
        raise ValueError(f"a data axis of {n_data} over {mesh.size} process(es): each "
                         "rank of the data axis is one process (launch with torchrun "
                         f"--nproc-per-node {n_data})")
    return mesh


def batch_stats_over(model: torch.nn.Module, mesh: Optional[DataMesh]):
    """A context in which every BatchNorm of ``model`` (models/convmixer.py)
    takes its train-mode statistics over ``mesh``'s global batch."""
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
