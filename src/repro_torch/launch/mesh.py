"""Mesh construction (counterpart of ``repro.launch.mesh``).

The reference builds a ``jax.sharding.Mesh`` over devices; here each rank
is one process of an initialised ``torch.distributed`` process group, and
:func:`make_mesh_from_cfg` gives a :class:`Mesh`: a ``DeviceMesh`` over
those ranks with the reference's axes (``("data", "model")`` or ``("pod",
"data", "model")``) and the two process groups a step needs — the rank's
model group (its TP peers, the same pod and data index) and its FSDP
group (pod × data at its model index: the weight gather's and the
gradient reduce-scatter's group). Ranks are numbered in mesh order, as
``dist.spec.mesh_coords`` reads them. :func:`spawn_ranks` starts the
ranks: processes on one machine that meet in a gloo group through a
``FileStore`` in a temporary directory (several may share one card).
Nothing here runs at import.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
from typing import Any

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist.spec import MeshCfg

SINGLE_POD = MeshCfg(tp=16, dp=16, pods=1)
MULTI_POD = MeshCfg(tp=16, dp=16, pods=2)


def mesh_cfg_for(*, multi_pod: bool = False) -> MeshCfg:
    return MULTI_POD if multi_pod else SINGLE_POD


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks' mesh and this rank's groups. ``fsdp`` is ``None`` (the
    default group) when the gather spans every rank (``tp == 1``);
    ``model`` is ``None`` when there is no model axis (``tp == 1``)."""

    cfg: MeshCfg
    device_mesh: DeviceMesh
    fsdp: Any = None
    model: Any = None


def make_mesh_from_cfg(mesh_cfg: MeshCfg) -> Mesh | None:
    """``None`` on the trivial mesh; otherwise the :class:`Mesh` over the
    ranks of the default process group. Its ``DeviceMesh`` is shaped
    ``mesh_cfg.shape`` with axes ``mesh_cfg.axis_names`` (the model axis
    dropped at ``tp == 1``); its device type is ``cpu``: the gloo
    collectives move host memory (``dist.comm``). At ``tp > 1`` the
    model group is the mesh's ``model`` dimension and the FSDP group its
    ``data`` dimension (with pods, ``pod`` × ``data`` flattened). Every
    rank calls this, in the same order (the groups are made
    collectively)."""
    if mesh_cfg.trivial:
        return None
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_from_cfg needs an initialised torch.distributed "
                           "process group (one rank a process)")
    world = dist.get_world_size()
    want = mesh_cfg.dshards * mesh_cfg.tp
    if world != want:
        raise ValueError(f"mesh {mesh_cfg.shape} needs {want} ranks, the process group "
                         f"has {world}")
    shape, names = mesh_cfg.shape, mesh_cfg.axis_names
    if mesh_cfg.tp == 1:
        shape, names = shape[:-1], names[:-1]
    device_mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape), mesh_dim_names=names)
    if mesh_cfg.tp == 1:
        return Mesh(mesh_cfg, device_mesh)
    fsdp_mesh = device_mesh["data"] if mesh_cfg.pods == 1 else device_mesh["pod", "data"]._flatten()
    return Mesh(mesh_cfg, device_mesh, fsdp=fsdp_mesh.get_group(),
                model=device_mesh.get_group("model"))


def fsdp_group(mesh: Mesh | None):
    """The weight gather's process group: the flattened pod × data group
    at this rank's model index (``None``, the default group, when that is
    every rank, and on the trivial mesh)."""
    return None if mesh is None else mesh.fsdp


def model_group(mesh: Mesh | None):
    """This rank's TP peers (``None``: no model axis)."""
    return None if mesh is None else mesh.model


def _rank_main(rank, fn, nprocs, tmp, args, threads, timeout_s):
    torch.set_num_threads(threads)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), nprocs), rank=rank,
        world_size=nprocs, timeout=datetime.timedelta(seconds=timeout_s),
    )
    try:
        out = fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ranks(fn, nprocs: int, *args, threads: int = 1, timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes joined in a
    gloo process group (the default group of each), and return their
    return values in rank order. ``fn`` must be importable by name (a
    module-level function). If a rank raises, the others are stopped and
    the error is raised here; a collective that waits longer than
    ``timeout_s`` fails. Each rank runs ``threads`` CPU threads."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        mp.spawn(_rank_main, args=(fn, nprocs, tmp, args, threads, timeout_s),
                 nprocs=nprocs, join=True)
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
