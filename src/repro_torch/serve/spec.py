"""Speculative decoding for the serve engine (counterpart of
``repro.serve.spec``).

A small **draft** model (the target shrunk, same vocabulary) proposes
``k`` tokens a slot with the request's own
:class:`~repro_torch.plan.SamplingParams` keys; the target then scores the
carried last-emitted token plus all k proposals in ONE ``(B, k + 1)``
verify decode step (:func:`repro_torch.serve.step.make_verify_step`) and
samples its own token at every block position with the same keys. The
engine emits the target's token at position j and keeps consuming the
block while the draft's next proposal equals it, so the emitted stream is
the non-speculative one by construction: the draft moves the acceptance
rate, never the stream.

Data motion: draft feeds and proposals and the verify block ride the
``host_device`` byte planes at ``token_wire_width`` bytes an id — per
round ``(k + 1) + k`` draft crossings and ``2 (k + 1)`` verify crossings
a slot (:func:`repro_torch.roofline.analysis.serve_spec_decode_bytes`,
equal to the engine's measured ``step_log``).

Cache discipline: the verify step advances every slot's ``pos`` by ``k +
1`` and writes the whole block; :func:`rollback_caches` then re-stamps
``pos`` back by each slot's count of rejected positions, in place (the
port's caches are updated in place). Entries past the new ``pos`` are
masked and the next block overwrites them.

On a mesh the draft lives on the target's mesh (:func:`build_draft`, each
rank its blocks) and its prefills and micro steps run on the rank's heads;
every step returns the logits gathered over the vocabulary slices, so the
proposals, the verify samples, the acceptance and the rollback deltas are
the same on every rank, and each rank rolls back its own caches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.spec import MeshCfg
from repro_torch.models import attention as A
from repro_torch.models.model import RECURRENT_STATES, node_leaves
from repro_torch.plan import PrecisionPlan
from repro_torch.serve.sampling import sample_tokens
from repro_torch.serve.step import init_serve_caches, make_decode_step, make_prefill_step
from repro_torch.transport.hostdev import (
    pack_tokens,
    pack_tokens_host,
    stage,
    unpack_tokens,
    unpack_tokens_host,
)

__all__ = [
    "DraftBundle",
    "DraftRunner",
    "build_draft",
    "check_spec_arch",
    "insert_slot",
    "make_draft_config",
    "rollback_caches",
]


def check_spec_arch(cfg: ModelConfig, *, window=None) -> None:
    """Speculative decoding serves pure-attention causal token models —
    the family where a k-token block write + pos rollback is exact
    (recurrent state and MoE capacity dispatch couple positions, image and
    feature payloads are not token-stageable, and ring caches physically
    overwrite on advance)."""
    if not cfg.causal:
        raise ValueError(f"{cfg.name} is encoder-only: nothing to serve")
    if cfg.num_image_tokens or cfg.embed_is_input_stub:
        raise ValueError(f"{cfg.name}: speculative decoding stages token payloads only")
    if cfg.num_experts or any(kind != "attn" for kind in cfg.pattern):
        raise ValueError(
            f"{cfg.name}: speculative decoding needs a pure-attention "
            "pattern (MoE capacity dispatch and recurrent state make "
            "block verify + rollback inexact)"
        )
    if cfg.sliding_window or window is not None:
        raise ValueError(
            f"{cfg.name}: speculative decoding keeps linear per-slot "
            "caches — ring (sliding-window) layouts overwrite on "
            "advance and cannot roll back"
        )


def make_draft_config(cfg: ModelConfig, name: str = "tiny") -> ModelConfig:
    """The draft model's config. ``"tiny"`` shrinks the target (2 layers,
    narrow width, one kv head) while keeping ``vocab_size``; any other
    name resolves through the registry and must match the target's
    vocabulary."""
    if name != "tiny":
        from repro_torch.configs.registry import get_config

        draft = get_config(name)
        if draft.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft {name}: vocab {draft.vocab_size} != target "
                f"vocab {cfg.vocab_size} — draft ids must be target ids"
            )
        check_spec_arch(draft)
        return draft
    heads = max(1, min(cfg.num_heads, 2))
    d_model = max(2 * heads, min(cfg.d_model, 128))
    return dataclasses.replace(
        cfg,
        name=f"{cfg.name}-draft-tiny",
        num_layers=2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=1,
        head_dim=0,  # -> d_model // heads
        d_ff=min(cfg.d_ff, 4 * d_model) if cfg.d_ff else 0,
        num_precision_groups=1,
        remat=False,
    )


@dataclasses.dataclass
class DraftBundle:
    """A draft model ready to serve: config, spec tree and weight storage
    (:func:`build_draft`; tests pass the target's own to pin acceptance
    1.0, or converted reference weights)."""

    cfg: ModelConfig
    spec_tree: object
    storage: object


def build_draft(cfg: ModelConfig, mesh_cfg: MeshCfg, name: str = "tiny", *, seed: int = 1,
                device="cuda", params=None) -> DraftBundle:
    """The draft of ``cfg`` on ``device``, on the target's mesh (as the
    reference's): random weights from ``seed`` (``repro_torch.models.init``),
    or ``params`` (a port tree of the draft config at the mesh's ``tp``,
    e.g. the reference's converted by
    :func:`repro_torch.convert.convert_lm_params`). On a sharded mesh every
    rank calls, and each gets its blocks."""
    from repro_torch.launch.train import setup_storage

    dcfg = make_draft_config(cfg, name)
    rank = 0 if mesh_cfg.trivial else dist.get_rank()
    spec_tree, storage = setup_storage(dcfg, mesh_cfg, device=torch.device(device),
                                       params=params, seed=seed, rank=rank)
    return DraftBundle(dcfg, spec_tree, storage)


def rollback_caches(caches, delta: torch.Tensor) -> None:
    """Re-stamp every cache node's per-slot ``pos`` back by ``delta`` (the
    per-slot count of rejected verify positions), in place. The data stays
    where it is: positions past the new ``pos`` are masked, and the next
    block overwrites them. Caches are ``[group][node]`` with ``pos
    (reps, slots)``; ``delta (slots,)``."""
    for group in caches:
        for node in group.values():
            if not isinstance(node, (A.KVCache, A.QuantKVCache, *A.PAGED)):
                raise TypeError("speculative rollback covers attention caches only "
                                f"(got {type(node).__name__})")
            node.pos.sub_(delta.to(node.pos))  # (B,) against (reps, B)


def insert_slot(big, small, slot: int) -> None:
    """Batch-of-1 prefill caches ``small`` -> slot ``slot`` of the slotted
    caches ``big``, in place; the pos leaves are the one rank mismatch:
    ``(R,)`` from prefill against ``(R, B)`` (a recurrent state has none)."""
    for big_g, small_g in zip(big, small):
        for key, node in big_g.items():
            s = small_g[key]
            for b_leaf, s_leaf in zip(node_leaves(node), node_leaves(s)):
                b_leaf[:, slot] = s_leaf[:, 0]
            if not isinstance(node, RECURRENT_STATES):
                node.pos[:, slot] = s.pos


class DraftRunner:
    """The engine's draft loop: per-slot contiguous caches kept in lockstep
    with the target's emitted streams (the same ``pos``, the same rollback
    deltas), one decode step at ``(B, 1)``, one prefill step.

    Each round, :meth:`propose` runs ``k + 1`` micro decode steps: step j
    feeds the previous token (the slot's last emitted id for j = 0) and
    samples proposal ``d_{j+1}`` with the request key at emitted index
    ``n + j``, the key the target uses for that position, so a draft that
    equals the target proposes the target's stream (acceptance 1.0). The
    last micro step only absorbs the last proposal into the cache."""

    def __init__(self, bundle: DraftBundle, mesh_cfg: MeshCfg, mesh, *, plan: PrecisionPlan,
                 max_slots: int, capacity: int, spec_k: int, token_width: int, device):
        check_spec_arch(bundle.cfg)
        cfg = bundle.cfg
        self.cfg = cfg
        self.mesh_cfg = mesh_cfg
        self.spec_tree = bundle.spec_tree
        self.storage = bundle.storage
        self.device = device
        self.max_slots = int(max_slots)
        self.capacity = int(capacity)
        self.spec_k = int(spec_k)
        self.token_width = int(token_width)
        # the serving plan under the draft's group count; its first weight
        # entry governs every draft group (a draft moves only the acceptance)
        self.plan = dataclasses.replace(
            plan, weights=(plan.weights[0],) * (cfg.num_groups + 1), seq_parallel=False,
        )
        self._decode = make_decode_step(cfg, mesh_cfg, mesh, self.spec_tree, plan=self.plan,
                                        shard_batch=False)
        self._prefill = make_prefill_step(cfg, mesh_cfg, mesh, self.spec_tree, plan=self.plan,
                                          cache_capacity=self.capacity, shard_batch=False)
        self.caches = None

    def reset(self) -> None:
        self.caches = None  # free the previous stream's caches first
        self.caches = init_serve_caches(
            self.cfg, self.mesh_cfg, self.max_slots, self.capacity,
            self.plan.compute_dtype, shard_batch=False, per_slot=True,
            int8_kv=self.plan.int8_kv, device=self.device,
        )

    def prefill_insert(self, tokens_dev, slot: int) -> None:
        """Absorb an admitted prompt into the draft's slot caches from the
        engine's already staged device tokens (no second h2d crossing)."""
        _, pcaches = self._prefill(self.storage, {"tokens": tokens_dev})
        insert_slot(self.caches, pcaches, slot)

    def propose(self, next_tok, pos_host, nemit, temp, top_p, top_k, seed, rec) -> np.ndarray:
        """One draft round: ``(B, spec_k)`` proposals, the draft caches
        advanced by ``spec_k + 1`` positions (the engine rolls them back
        after acceptance). Every feed and proposal crossing is priced into
        ``rec["host_device"]`` as plane bytes."""
        B, k, w = self.max_slots, self.spec_k, self.token_width
        feed = np.asarray(next_tok, np.int32).copy()
        drafts = np.zeros((B, k), np.int32)
        for j in range(k + 1):
            planes = pack_tokens_host(feed[:, None], w)  # (w, B, 1)
            rec["host_device"] += planes.nbytes
            batch = {"tokens": unpack_tokens(stage(planes, self.device)),
                     "pos": stage(pos_host + j, self.device)}
            logits, self.caches = self._decode(self.storage, self.caches, batch)
            if j == k:
                break  # absorb the last proposal only; its logits are the next round's
            tok = sample_tokens(logits[:, -1], self.cfg.vocab_size, temp, top_p, top_k,
                                seed, nemit + j)
            out_planes = pack_tokens(tok, w).cpu().numpy()  # (w, B) — d2h proposal
            rec["host_device"] += out_planes.nbytes
            feed = unpack_tokens_host(out_planes).astype(np.int32)
            drafts[:, j] = feed
        return drafts

    def rollback(self, delta: torch.Tensor) -> None:
        rollback_caches(self.caches, delta)
