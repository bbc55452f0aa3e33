"""Pinned-transpose collective pairs for manual tensor parallelism
(counterpart of ``repro.core.collectives``): thin shims over
:mod:`repro_torch.transport`.

Megatron-style TP needs two conjugate operators around each block:

  * :func:`tp_region_enter` ("f"): forward identity on the (model-group
    replicated) activations, backward all-reduce of the cotangent over
    the model group — column-parallel weights each produce a partial
    ``dx``.
  * :func:`tp_region_exit` ("g"): forward all-reduce of the partial block
    output over the model group, backward identity.

Both directions are pinned by ``torch.autograd.Function`` rather than
left to autograd's view of a collective, whose transpose for replicated
inputs double-counts. The movers inside are :mod:`repro_torch.transport`'s:
an activation :class:`~repro_torch.transport.CompressionPolicy` routes
every all-reduce through the packed reduce-scatter + all-gather
(``transport.all_reduce``; the forward at ``round_to``, the cotangent at
``grad_round_to``), and the sequence-parallel pair through
``transport.seq_gather`` / ``transport.seq_scatter``.

As in the reference: activations entering :func:`tp_region_enter` are
replicated over the model group, partial outputs entering
:func:`tp_region_exit` are unreduced partials; an uncompressed cotangent
all-reduce runs in the forward input's dtype (the cotangent is cast to
it first); ``policy=None`` is uncompressed. ``group`` is the model
group's process group; ``traffic`` names the log's class of the
all-reduces (``activations``; the loss's sums pass ``loss``).
"""
from __future__ import annotations

import torch

from repro_torch.dist import comm
from repro_torch.transport import policy_for
from repro_torch.transport import transport as _T


def _act_policy(policy):
    """None -> None (uncompressed); else a CompressionPolicy."""
    return None if policy is None else policy_for(policy)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, policy, traffic):
        ctx.group, ctx.policy, ctx.traffic, ctx.dtype = group, policy, traffic, x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.dtype)
        pol = _act_policy(ctx.policy)
        if pol is not None and pol.compresses_grads:
            out = _T.all_reduce(g, ctx.group, pol, use_grad_format=True, traffic=ctx.traffic)
        else:
            out = comm.all_reduce(g, ctx.group, traffic=ctx.traffic)
        return out, None, None, None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, policy, traffic):
        ctx.dtype = x.dtype
        pol = _act_policy(policy)
        if pol is not None and pol.compresses:
            return _T.all_reduce(x, group, pol, use_grad_format=False, traffic=traffic)
        return comm.all_reduce(x, group, traffic=traffic)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None, None


def tp_region_enter(x, group, policy=None, traffic: str = "activations"):
    """Megatron "f": identity forward, model-group all-reduce of the
    cotangent (packed at the policy's ``grad_round_to`` when it
    compresses)."""
    return _Enter.apply(x, group, policy, traffic)


def tp_region_exit(x, group, policy=None, traffic: str = "activations"):
    """Megatron "g": model-group all-reduce forward (packed at the
    policy's ``round_to`` when it compresses), identity backward."""
    return _Exit.apply(x, group, policy, traffic)


def seq_gather(x, group, policy=None, axis: int = 1):
    """Sequence-parallel enter: all-gather sequence shards over the model
    group (axis 1 = sequence), reduce-scatter backward; an activation
    policy compresses the forward (``round_to``) and the cotangent
    (``grad_round_to``)."""
    return _T.seq_gather(x, group, _act_policy(policy) or policy_for(4), axis)


def seq_scatter(x, group, policy=None, axis: int = 1):
    """Sequence-parallel exit: reduce-scatter partial outputs over the
    model group along the sequence dim, all-gather backward (the
    contract of :func:`seq_gather`)."""
    return _T.seq_scatter(x, group, _act_policy(policy) or policy_for(4), axis)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        n = torch.distributed.get_world_size(group)
        loc = x.shape[axis] // n
        return x.narrow(axis, torch.distributed.get_rank(group) * loc, loc).contiguous()

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g, ctx.group, axis=ctx.axis, traffic="relayout"), None, None


class _Merge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return comm.all_gather(x, group, axis=axis, traffic="relayout")

    @staticmethod
    def backward(ctx, g):
        n = torch.distributed.get_world_size(ctx.group)
        loc = g.shape[ctx.axis] // n
        rank = torch.distributed.get_rank(ctx.group)
        return g.narrow(ctx.axis, rank * loc, loc).contiguous(), None, None


def seq_split(x, group, axis: int = 1):
    """Replicated activation -> this rank's sequence shard: forward slice,
    backward uncompressed all-gather of the shard cotangents (the
    conjugate of :func:`seq_gather` for tensors already equal on every
    model rank). ``x.shape[axis]`` must divide by the group size."""
    return _Split.apply(x, group, axis)


def seq_merge(x, group, axis: int = 1):
    """Sequence shards -> the full replicated sequence, for compute that
    is replicated over the model group: forward all-gather, backward
    slice (:func:`seq_split`'s inverse; not :func:`seq_gather`'s twin,
    whose reduce-scatter backward would count a replicated cotangent
    once per rank)."""
    return _Merge.apply(x, group, axis)
