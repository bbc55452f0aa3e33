"""Trainer-side weight publishing (counterpart of ``repro.fleet.publish``).

:class:`WeightPublisher` snapshots a ``storage`` tree as a
:class:`~repro_torch.transport.WeightParcel` at the width controller's
current ``round_tos`` (the sharded checkpointer's
:func:`~repro_torch.checkpoint.sharded.assign_widths` walk), and can mirror
it to a ``save_sharded`` directory: parcel and directory hold the same
bytes, so ``parcel.nbytes == manifest_bytes(...) == train_checkpoint_bytes(...)``.
"""
from __future__ import annotations

from repro_torch.transport import pack_weight_parcel


class WeightPublisher:
    """Versioned publisher over one model's ``spec_tree``: each
    :meth:`publish` stamps the next version number, which the router's
    rolling refresh keys replica installs on."""

    def __init__(self, cfg, spec_tree, *, plan):
        self.spec_tree = spec_tree
        self.plan = plan.broadcast(cfg.num_groups + 1)
        self.policy = self.plan.weight_publish_policy()
        self.next_version = 0

    def publish(self, storage, *, round_tos=None, step: int = 0, save_dir=None, awp=None):
        """Pack ``storage`` into the next version's parcel at ``round_tos``
        (default the plan's widths; pass an AWP controller's current ones
        for a width-aware publish), and with ``save_dir`` also write the
        matching sharded checkpoint there."""
        rts = tuple(round_tos) if round_tos is not None else self.plan.round_tos
        parcel = pack_weight_parcel(storage, spec_tree=self.spec_tree, round_tos=rts,
                                    policy=self.policy, version=self.next_version, step=step)
        if save_dir is not None:
            from repro_torch.checkpoint.sharded import save_sharded

            save_sharded(save_dir, storage, None, awp, step, plan=self.plan,
                         spec_tree=self.spec_tree, round_tos=rts, residuals=parcel.residuals)
        self.next_version += 1
        return parcel
