"""Recording the collectives a step issues, without running it on data
(counterpart of ``repro.audit.jaxpr``).

The reference traces a step into a jaxpr and walks it for communication
equations. PyTorch runs eagerly and has no jaxpr, so the port runs the
step instead, on nothing: :func:`recording` joins this process to a
``fake`` process group as rank ``rank`` of the mesh's world (every
collective returns at once and moves nothing), builds the rank's
:class:`~repro_torch.launch.mesh.Mesh`, and enters ``FakeTensorMode``
(every tensor made inside has a shape, a dtype and a device but no
storage: a full-width model at the production mesh allocates nothing).
Each collective the code inside issues goes through
:mod:`repro_torch.dist.comm` as it would on gloo, and lands in
:data:`comm.LOG <repro_torch.dist.comm.LOG>` as a
:class:`~repro_torch.dist.comm.CommRecord`: kind, payload dtype and
shape, the group's ranks, and the caller's ``traffic`` label, which the
auditor checks and does not trust.

What the walker sees and the recorder does not: a ``scan`` runs its body
once and the walker multiplies by its length; here every layer runs, so
a record is one call (``mult`` has no counterpart). Collectives under
data-dependent control flow cannot hide either: the step runs the
branch it takes, on fake data, and an op that needs data (``.item()``,
``nonzero``) raises inside the recorder, naming the op.

Rank-dependent code (``dist.get_rank``, the slot owner, the last model
rank) sees the fake rank: record the ranks whose inventory differs.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist

from repro_torch.dist import comm


class Recording:
    """What :func:`recording` yields: the rank's ``mesh`` (``None`` on the
    trivial mesh), its ``mesh_cfg`` and ``rank``, and :attr:`records`,
    the :class:`~repro_torch.dist.comm.CommRecord` of every collective
    issued inside, in call order."""

    def __init__(self, mesh_cfg, mesh, rank: int):
        self.mesh_cfg = mesh_cfg
        self.mesh = mesh
        self.rank = rank
        self._first = len(comm.LOG)
        self._records: list | None = None

    @property
    def records(self) -> list:
        if self._records is not None:
            return list(self._records)
        return comm.LOG[self._first:]

    def _close(self) -> None:
        self._records = comm.LOG[self._first:]
        del comm.LOG[self._first:]


@contextlib.contextmanager
def recording(mesh_cfg, *, rank: int = 0):
    """Run the body as rank ``rank`` of ``mesh_cfg``'s world on a fake
    process group under ``FakeTensorMode``; yields a :class:`Recording`.
    Needs a process with no process group of its own (``RuntimeError``
    otherwise). On exit, always, the group is destroyed and the calls
    are taken out of ``comm.LOG`` (they stay in :attr:`Recording.records`)."""
    # importing the module registers the ``fake`` backend with torch.distributed
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh_from_cfg

    if dist.is_initialized():
        raise RuntimeError("recording needs a process without a process group: this one "
                           "has one")
    world = mesh_cfg.dshards * mesh_cfg.tp
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside the mesh's {world} ranks")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    rec = None
    try:
        rec = Recording(mesh_cfg, make_mesh_from_cfg(mesh_cfg), rank)
        with FakeTensorMode(allow_non_fake_inputs=True):
            yield rec
    finally:
        if rec is not None:
            rec._close()
        dist.destroy_process_group()


def collect_comm_calls(fn, *args, **kwargs) -> list:
    """The collectives ``fn(*args, **kwargs)`` issues, in call order (the
    counterpart of ``collect_comm_eqns``); call it inside
    :func:`recording`."""
    first = len(comm.LOG)
    fn(*args, **kwargs)
    return comm.LOG[first:]
