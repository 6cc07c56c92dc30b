"""Device mesh construction over a ``torch.distributed`` process group.

Counterpart of ``bbocr_tpu/parallel/mesh.py``. The JAX package runs one
controller and lets GSPMD partition its programs over a ``jax.sharding.Mesh``
of ``dp`` (data/batch) x ``tp`` (tensor) axes. The port runs SPMD over a
process group instead: one process per card (NCCL) or per CPU rank (gloo),
every rank making the same calls, with the collectives GSPMD would insert
written out (``parallel/collectives.py``). A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` of shape (dp, tp) with the
dimension names ``("dp", "tp")`` over ranks of the default group; ranks
that share a ``dp`` coordinate form a ``tp`` group and split the widest
products, ranks that share a ``tp`` coordinate form a ``dp`` group and
split the batch.

Start a multi-card run with ``torchrun --standalone --nproc_per_node N``
(a rendezvous on localhost) and ``torch.distributed.init_process_group
("nccl")`` in each process before ``make_mesh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshConfig:
    dp: Optional[int] = None  # None: all remaining devices
    tp: int = 1


def _mesh_shape(config: MeshConfig, n: int):
    tp = config.tp
    if n % tp != 0:
        raise ValueError(f"tp={tp} does not divide device count {n}")
    dp = config.dp if config.dp is not None else n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp * tp} != device count {n}")
    return dp, tp


def make_mesh(config: MeshConfig = MeshConfig(), devices: Optional[Sequence[int]] = None):
    """A (dp, tp) ``DeviceMesh`` named ``("dp", "tp")`` over ``devices``,
    ranks of the default process group (all of them by default), laid out
    row-major as the JAX mesh lays out its devices. Every rank of the
    default group calls it. The device type follows the group's backend:
    ``cuda`` for NCCL, ``cpu`` for gloo."""
    from torch.distributed.device_mesh import DeviceMesh

    if devices is not None:
        dp, tp = _mesh_shape(config, len(devices))
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: torch.distributed.init_process_group(...) "
            "in every process (under torchrun), or single_device_mesh()"
        )
    if devices is None:
        devices = range(dist.get_world_size())
        dp, tp = _mesh_shape(config, len(devices))
    ranks = torch.tensor(list(devices), dtype=torch.int64).reshape(dp, tp)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks, mesh_dim_names=("dp", "tp"))


def single_device_mesh(device="cuda"):
    """A 1x1 mesh of this rank. Where no process group is initialised, it
    first initialises a one-rank group on an in-memory store (no TCP port,
    no network): NCCL for a card, gloo only for ``device="cpu"``. A failed
    initialisation raises; nothing falls back to another backend."""
    dev = torch.device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index if dev.index is not None else torch.cuda.current_device())
            torch.cuda.set_device(dev)
            dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=dev)
        elif dev.type == "cpu":
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        else:
            raise ValueError(f"single_device_mesh takes a cuda or cpu device, got {device!r}")
    return make_mesh(MeshConfig(dp=1, tp=1), devices=[dist.get_rank()])
