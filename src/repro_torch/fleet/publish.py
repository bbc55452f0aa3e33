"""Trainer-side weight publishing (counterpart of ``repro.fleet.publish``).

:class:`WeightPublisher` snapshots a ``storage`` tree as a
:class:`~repro_torch.transport.WeightParcel` at the width controller's
current ``round_tos`` (the sharded checkpointer's
:func:`~repro_torch.checkpoint.sharded.assign_widths` walk), and can mirror
it to a ``save_sharded`` directory: parcel and directory hold the same
bytes, so ``parcel.nbytes == manifest_bytes(...) == train_checkpoint_bytes(...)``.

On a sharded mesh every rank publishes its blocks and gets the parcel of
the mesh's global storage (``pack_weight_parcel(..., mesh_cfg=)``: each
leaf's planes gathered to every rank), as the reference's publisher
encodes its global arrays, so every rank holds the same parcel, byte-equal
to the reference's at that mesh. Like a checkpoint, it installs only at a
mesh whose storage shapes match it.
"""
from __future__ import annotations

from repro_torch.checkpoint.sharded import save_sharded
from repro_torch.transport import pack_weight_parcel


class WeightPublisher:
    """Versioned publisher over one model's ``spec_tree``: each
    :meth:`publish` stamps the next version number, which the router's
    rolling refresh keys replica installs on."""

    def __init__(self, cfg, spec_tree, *, plan, mesh_cfg=None):
        self.spec_tree = spec_tree
        self.mesh_cfg = mesh_cfg
        self.plan = plan.broadcast(cfg.num_groups + 1)
        self.policy = self.plan.weight_publish_policy()
        self.next_version = 0

    def publish(self, storage, *, round_tos=None, step: int = 0, save_dir=None, awp=None):
        """Pack ``storage`` into the next version's parcel at ``round_tos``
        (default the plan's widths; pass an AWP controller's current ones
        for a width-aware publish), and with ``save_dir`` also write the
        matching sharded checkpoint there. On a sharded mesh ``storage`` is
        the rank's blocks and every rank calls."""
        rts = tuple(round_tos) if round_tos is not None else self.plan.round_tos
        parcel = pack_weight_parcel(storage, spec_tree=self.spec_tree, round_tos=rts,
                                    policy=self.policy, version=self.next_version, step=step,
                                    mesh_cfg=self.mesh_cfg)
        if save_dir is not None:
            save_sharded(save_dir, storage, None, awp, step, plan=self.plan,
                         spec_tree=self.spec_tree, round_tos=rts, residuals=parcel.residuals,
                         mesh_cfg=self.mesh_cfg)
        self.next_version += 1
        return parcel
