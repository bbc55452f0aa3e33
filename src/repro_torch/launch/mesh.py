"""Mesh construction (counterpart of ``repro.launch.mesh``).

The reference builds a ``jax.sharding.Mesh`` over devices; here each rank
is one process of an initialised ``torch.distributed`` process group, and
the mesh is a ``DeviceMesh`` over those ranks. Only data parallelism is
ported (``tp == 1``): the mesh's axes are ``("data",)`` or ``("pod",
"data")``, and the weight gather runs over the flattened pod × data group.
:func:`spawn_ranks` starts the ranks: processes on one machine that meet
in a gloo group through a ``FileStore`` in a temporary directory (several
may share one card). Nothing here runs at import.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist.spec import MeshCfg

SINGLE_POD = MeshCfg(tp=16, dp=16, pods=1)
MULTI_POD = MeshCfg(tp=16, dp=16, pods=2)


def mesh_cfg_for(*, multi_pod: bool = False) -> MeshCfg:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_mesh_from_cfg(mesh_cfg: MeshCfg) -> DeviceMesh | None:
    """``None`` on the trivial mesh; otherwise a ``DeviceMesh`` over the
    ranks of the default process group, shaped ``(pods, dp)`` or ``(dp,)``
    with axes ``("pod", "data")`` or ``("data",)``. Its device type is
    ``cpu``: the gloo collectives move host memory (``dist.comm``). Every
    rank calls this, in the same order."""
    if mesh_cfg.trivial:
        return None
    if mesh_cfg.tp > 1:
        raise NotImplementedError(
            f"tensor parallelism is not ported (got tp={mesh_cfg.tp}; the FSDP×TP "
            "slice, ROADMAP Queue 1 item 6.1)"
        )
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_from_cfg needs an initialised torch.distributed "
                           "process group (one rank a process)")
    world = dist.get_world_size()
    if world != mesh_cfg.dshards:
        raise ValueError(f"mesh {mesh_cfg.shape} needs {mesh_cfg.dshards} ranks, the "
                         f"process group has {world}")
    shape = mesh_cfg.shape[:-1]  # tp == 1: drop the model axis
    names = mesh_cfg.axis_names[:-1]
    ranks = torch.arange(world).reshape(shape)
    return DeviceMesh("cpu", ranks, mesh_dim_names=names)


def fsdp_group(mesh: DeviceMesh | None):
    """The weight gather's process group: the flattened pod × data group.
    With ``tp == 1`` that is every rank of the mesh, which spans the
    default group, so the default group (``None``) is it; the trivial
    mesh has none either."""
    if mesh is not None and mesh.mesh.numel() != dist.get_world_size():
        raise ValueError("the mesh must span the default process group")
    return None


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
