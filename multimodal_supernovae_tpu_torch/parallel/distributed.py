"""Joining a process group for data- and tensor-parallel training (port of
multimodal_supernovae_tpu/parallel/distributed.py).

The JAX package runs one controller process a host over that host's chips.
The port runs one process a card, as ``torchrun`` launches it::

  torchrun --nproc-per-node 8 -m multimodal_supernovae_tpu_torch train \\
      configs/maven_pretrain.yaml --mesh            # an 8 x 1 (data, model) mesh
  torchrun --nproc-per-node 8 -m multimodal_supernovae_tpu_torch train \\
      configs/maven_pretrain.yaml --mesh --tp 2     # 4 x 2

  * ``initialize()`` joins a ``torch.distributed`` process group when the
    environment names one, and is a no-op (False) otherwise. It reads, in
    this order, its arguments, torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``, then the JAX
    package's ``MMSN_COORDINATOR`` / ``MMSN_NUM_PROCESSES`` /
    ``MMSN_PROCESS_ID``. The backend is NCCL for the card and gloo for the
    CPU; the ``backend`` argument asks for another (gloo on the card lets
    two ranks share one card, which NCCL refuses). Each rank's card is
    ``cuda:LOCAL_RANK``. A collective that waits longer than ``timeout``
    seconds fails instead of hanging.
  * ``make_global_mesh(n_model)`` is the ``(data, model)`` mesh over every
    process of the group (``parallel/mesh.py:DataMesh``), the model axis
    innermost; n_model must divide the group's size.
  * ``add_mesh_args`` / ``mesh_from_args``: the CLIs' ``--mesh`` and
    ``--tp``, with the JAX meaning: a mesh when ``--mesh`` is given or the
    process was launched as one of several. One rule departs from the JAX
    package: ``--mesh`` in a single process that sees more than one card
    raises, telling the user to launch under torchrun, since the JAX
    single-controller mesh over a host's chips has no torch counterpart.
    ``--tp N`` (which implies ``--mesh``) is the model axis's size; it must
    divide the number of ranks.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from .mesh import DataMesh, make_mesh

_ENV_COORD = "MMSN_COORDINATOR"
_ENV_NPROC = "MMSN_NUM_PROCESSES"
_ENV_PID = "MMSN_PROCESS_ID"
TIMEOUT_S = 600.0

_device: Optional[torch.device] = None  # this rank's device, set by initialize


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_rank: Optional[int] = None,
               device="cuda", backend: Optional[str] = None,
               timeout: float = TIMEOUT_S) -> bool:
    """Join the process group the arguments or the environment name and
    return True; return False when none is named, or when this process has
    joined one already. ``coordinator_address`` is ``host:port`` or a
    ``tcp://`` / ``file://`` URL. ``device`` is where this rank trains:
    ``cuda`` (the default) means ``cuda:<local rank>``."""
    global _device
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    coordinator_address = coordinator_address or env.get(_ENV_COORD)
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
        num_processes = _env_int(_ENV_NPROC) if num_processes is None else num_processes
    if process_id is None:
        process_id = _env_int("RANK")
        process_id = _env_int(_ENV_PID) if process_id is None else process_id
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs its coordinator address, process count and this "
            f"process's id; got {coordinator_address!r}, {num_processes!r}, {process_id!r}")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        if device.index is None:
            if local_rank is None:
                local_rank = process_id % torch.cuda.device_count()
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address), rank=process_id,
        world_size=num_processes, timeout=datetime.timedelta(seconds=timeout), **kwargs)
    _device = device
    return True


def local_device() -> torch.device:
    """This rank's device (``initialize``'s), else the CPU."""
    return _device if _device is not None else torch.device("cpu")


def make_global_mesh(n_model: int = 1, device=None) -> DataMesh:
    """The ``(data, model)`` mesh over every process of the group (one rank a
    card), the model axis innermost."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    if n_model < 1 or n % n_model:
        raise ValueError(f"{n} global devices not divisible by model={n_model}")
    return make_mesh(n_model=n_model, device=device)


def shutdown() -> None:
    """Leave the process group (if any), so the process exits cleanly."""
    global _device
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def add_mesh_args(ap) -> None:
    """Attach the shared --mesh/--tp CLI flags to an argparse parser."""
    ap.add_argument("--mesh", action="store_true",
                    help="shard training over the ranks of a torchrun launch, one process "
                         "a card (data x model mesh)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model (tensor-parallel) axis size; implies --mesh")


def mesh_from_args(args, device="cuda", backend: Optional[str] = None
                   ) -> Optional[DataMesh]:
    """Resolve the CLI mesh request: join the process group when the
    environment names one, then build the ``(data, model)`` mesh when
    ``--mesh`` or ``--tp`` above 1 asked for it or this process is one of
    several. Returns None for a plain one-process run."""
    import torch.distributed as dist

    tp = int(getattr(args, "tp", 1) or 1)
    joined = initialize(device=device, backend=backend)
    if not (getattr(args, "mesh", False) or tp > 1 or joined or dist.is_initialized()):
        return None
    if (not dist.is_initialized() and torch.device(device).type == "cuda"
            and torch.cuda.device_count() > 1):
        raise RuntimeError(
            f"--mesh in a single process that sees {torch.cuda.device_count()} cards: "
            "the port trains one process a card; launch under torchrun "
            f"(torchrun --nproc-per-node {torch.cuda.device_count()} -m "
            "multimodal_supernovae_tpu_torch train ... --mesh)")
    mesh = make_global_mesh(n_model=tp, device=None if dist.is_initialized() else device)
    if mesh.is_main:
        print(f"mesh: {mesh.shape} over {mesh.size} process(es), "
              f"{mesh.backend or 'no process group'}", flush=True)
    return mesh
