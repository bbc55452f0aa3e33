"""FSDP×TP training of the dense LM across gloo ranks: the port against the
JAX reference.

The reference's outputs come from one subprocess of this file (``python
tests/test_torch_tp.py INPUTS OUT``) run with 4 emulated host devices,
calling only the reference's public functions: ``tree_to_storage`` and
``leaf_partition_spec`` (the per-device shards, read off a
``NamedSharding``), ``transport.all_reduce`` / ``seq_gather`` /
``seq_scatter`` inside ``shard_map`` over a 2-device model axis, and
``make_train_step`` at ``MeshCfg(tp=2, dp=2)``. The port runs as 4 gloo
ranks, processes spawned by ``repro_torch.launch.mesh.spawn_ranks`` (one
CPU thread each), once for the module. Inputs are numpy from seeds: reduced
qwen3-1.7b (2 layers, d 256, 4 heads over 4 kv heads, hd 64, d_ff 512,
vocab 512) with the reference's ``init_params(cfg, PRNGKey(0), tp=2)``
weights, converted, and ``synthetic_lm_batch`` at B 8, S 32.

Tolerances. Storage layouts, per-rank shards and wire bytes are equal,
byte for byte. The transport's ``all_reduce`` (round_to 2 and 3, truncate
and nearest, and the uncompressed fallback), ``seq_gather`` and
``seq_scatter``, forward and backward, are bit-equal: contributions are
summed in rank order in fp32 on both sides (two ranks). The TP MLP's
gradient through ``tp_region_enter`` / ``tp_region_exit`` is within rtol
1e-5 of the one-device gradient. Two steps of each plan — ``round_to=2``;
with ``act_round_to=2``; with ``seq_parallel``; with ``grad_round_to=2``
— and, since the step ported them, stochastic rounding of the weights
and gradients (keys ``PRNGKey(step)``), ``accum_steps=2`` and the bf16
compute dtype, hold the loss and ``group_norms_sq`` to rtol 1e-5 of the
reference's (seen: losses bit-equal except act2, 3.5e-6 at the second
step, and grad2, stoch and accum, 7.6e-8; bf16 within rtol 1e-4, seen
2.0e-5; Σw² within 2.4e-7) and the updated shards to the
``UPDATE_BOUNDS`` of each plan. Inside the port the sequence-parallel
layout gives the psum layout's losses, norms and weights bit for bit, as
in the reference. The wire tables, the launcher twin and the rehearsal of
``chip_smoke.py`` phase 13 are in ``tests/test_torch_tp_launch.py``.
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.models.init import init_params as j_init_params
from repro_torch.plan import PrecisionPlan

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TP, DP = 2, 2
B, S, LR, STEPS = 8, 32, 0.05, 2
# (label, PrecisionPlan.build keywords at round_to 2) of the train-step runs
PLANS = (
    ("rt2", {}),
    ("act2", {"act_round_to": 2}),
    ("seq", {"seq_parallel": True}),
    ("grad2", {"grad_round_to": 2}),
    # stochastic rounding of the weight gathers and the gradient
    # reduce-scatter (the step takes PRNGKey(step)), gradient accumulation,
    # and the bf16 compute dtype
    ("stoch", {"mode": "stochastic", "grad_round_to": 2, "grad_mode": "stochastic"}),
    ("accum", {"accum_steps": 2}),
    ("bf16", {"dtype": "bf16"}),
)
# (round_to, mode) of the activation-path transport cases; 4 = uncompressed
ACT_CASES = ((2, "truncate"), (2, "nearest"), (3, "truncate"), (3, "nearest"), (4, "nearest"))
ACT_SHAPE = (4, 32, 64)  # (B, S, d) of an activation; S is split by seq_gather/scatter
# (atol, relative l2 of the update) of each plan's updated weights against
# the reference's. fp32 matmuls sum in another order in XLA and PyTorch,
# so a value that the compressed plans round to bf16 nearest (the
# activations of every TP-region all-reduce, act2; the gradient blocks,
# grad2) and that lies within that noise of a rounding midpoint lands one
# bf16 step apart in the two packages. Under act2 one such flip in a
# forward all-reduce moves every value downstream, so the flips cascade
# (seen after two steps: max 1.7e-5 apart, the update within 3.1e-3
# relative l2); under grad2 they stay in the flipped blocks (1.5e-6,
# 1.5e-4); without rounding, 6.0e-8 and 4.8e-5 (the q_norm scales, whose
# masters near 1.0 differ by one ulp against updates of ~5e-4).
# Stochastic rounding draws the same noise in both packages (the same keys
# folded at the same sites), so it flips like grad2: a rounded value within
# fp32 noise of a boundary (seen: 6.1e-6, 3.1e-4). Accumulation sums the
# micro-batches' gradients in the same order (seen: 1.2e-7, 1.1e-4). bf16
# compute rounds every activation to 8 bits, at other places in XLA's fused
# loops than in PyTorch's ops (seen: 4.9e-5, 1.6e-2).
UPDATE_BOUNDS = {"rt2": (1e-6, 1e-3), "seq": (1e-6, 1e-3), "grad2": (1e-5, 1e-3),
                 "act2": (1e-4, 1e-2), "stoch": (1e-5, 1e-3), "accum": (1e-6, 1e-3),
                 "bf16": (1e-4, 5e-2)}
# the losses' rtol: bf16 rounds the logits' inputs (seen: 2.0e-5); 1e-5 else
LOSS_RTOL = {"bf16": 1e-4}


def _cfgs():
    from repro_torch.configs.registry import get_config, reduced

    return j_reduced(j_get_config("qwen3-1.7b")), reduced(get_config("qwen3-1.7b"))


def _paths(tree):
    """{path: leaf} of a reference or port tree (dicts and lists)."""
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _inputs() -> dict:
    """numpy inputs from seeds: the reference's weights at tp 2 and the
    transport cases' activations."""
    jcfg, _ = _cfgs()
    params, _ = j_init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    out = {f"w{k}": np.asarray(v) for k, v in _paths(params).items()}
    rng = np.random.default_rng(0)
    out["act"] = rng.normal(0, 1, ACT_SHAPE).astype(np.float32)
    out["cot"] = rng.normal(0, 1, ACT_SHAPE).astype(np.float32)
    out["mlp_x"] = rng.normal(0, 1, (8, 16)).astype(np.float32)
    out["mlp_w1"] = rng.normal(0, 0.3, (16, 32)).astype(np.float32)
    out["mlp_w2"] = rng.normal(0, 0.3, (32, 16)).astype(np.float32)
    return out


def _params(inputs):
    """The reference-layout weights as a numpy tree."""
    jcfg, _ = _cfgs()
    shapes = jax.eval_shape(lambda k: j_init_params(jcfg, k, tp=TP)[0], jax.random.PRNGKey(0))
    flat = [inputs[f"w{k}"] for k in _paths(shapes)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), flat)


def _policy_kw(rt, mode):
    return dict(round_to=rt, grad_round_to=rt, mode=mode, grad_mode=mode)


# ---------------------------------------------------------------------------
# the reference (a subprocess of this file, 4 emulated host devices)
# ---------------------------------------------------------------------------


def _shards(arr, mesh, pspec):
    """{rank: numpy block} of a global array under ``pspec`` (rank = the
    device's place in the mesh, mesh order)."""
    from jax.sharding import NamedSharding

    placed = jax.device_put(arr, NamedSharding(mesh, pspec))
    devs = list(mesh.devices.flat)
    return {devs.index(s.device): np.asarray(s.data) for s in placed.addressable_shards}


def _reference(inputs_path, out_path):
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.core.collectives import seq_merge, seq_split
    from repro.plan import PrecisionPlan as JPlan
    from repro.data.pipeline import synthetic_lm_batch as j_batch
    from repro.dist.shard import shard_map
    from repro.dist.spec import MeshCfg as JMesh
    from repro.dist.spec import build_spec_tree, leaf_partition_spec, tree_to_storage
    from repro.launch.mesh import make_mesh_from_cfg
    from repro.optim.sgd import SGDConfig, init_momentum
    from repro.train.step import make_train_step
    from repro.transport import transport as jT
    from repro.transport.policy import CompressionPolicy as JPolicy

    inputs = dict(np.load(inputs_path))
    res = {}
    jcfg, _ = _cfgs()
    mcfg = JMesh(tp=TP, dp=DP)
    mesh = make_mesh_from_cfg(mcfg)
    params = jax.tree_util.tree_map(jnp.asarray, _params(inputs))
    _, metas = j_init_params(jcfg, None, tp=TP)
    spec = build_spec_tree(params, metas, mcfg)
    storage = tree_to_storage(params, spec, mcfg)
    specs = _paths(spec)
    for k, v in _paths(storage).items():
        res[f"storage{k}"] = np.asarray(v)
        for r, blk in _shards(v, mesh, leaf_partition_spec(specs[k], mcfg)).items():
            res[f"shard/{r}{k}"] = blk

    # the activation path over a 2-device model axis
    m2 = Mesh(np.array(jax.devices()[:TP]), ("model",))
    x, g = jnp.asarray(inputs["act"]), jnp.asarray(inputs["cot"])
    stacked, seqd = P("model"), P(None, "model", None)

    def run(fn, in_specs, out_specs, *args):
        return np.asarray(jax.jit(shard_map(fn, mesh=m2, in_specs=in_specs,
                                            out_specs=out_specs))(*args))

    for rt, mode in ACT_CASES:
        pol = JPolicy(**_policy_kw(rt, mode))
        gpol = JPolicy(round_to=4, grad_round_to=rt, grad_mode=mode)
        tag = f"{rt}/{mode}"

        def scale(v):
            return v * (lax.axis_index("model") + 1.0)

        res[f"ar/{tag}"] = run(lambda v, pol=pol: jT.all_reduce(scale(v), "model", pol)[None],
                               P(), stacked, x)
        res[f"ar_grad/{tag}"] = run(
            lambda v, gpol=gpol: jT.all_reduce(scale(v), "model", gpol,
                                               use_grad_format=True)[None], P(), stacked, x)
        res[f"sg/{tag}"] = run(lambda v, pol=pol: jT.seq_gather(v, "model", pol, 1)[None],
                               seqd, stacked, x)

        def sg_bwd(v, c, pol=pol):
            _, vjp = jax.vjp(lambda a: jT.seq_gather(a, "model", pol, 1), v)
            return vjp(scale(c))[0]

        res[f"sg_bwd/{tag}"] = run(sg_bwd, (seqd, P()), seqd, x, g)
        res[f"ss/{tag}"] = run(lambda v, pol=pol: jT.seq_scatter(scale(v), "model", pol, 1),
                               P(), seqd, x)

        def ss_bwd(v, c, pol=pol):
            _, vjp = jax.vjp(lambda a: jT.seq_scatter(a, "model", pol, 1), scale(v))
            return vjp(c)[0][None]

        res[f"ss_bwd/{tag}"] = run(ss_bwd, (P(), seqd), stacked, x, g)

    # the lossless sequence split and merge (core.collectives)
    def split_bwd(v, c):
        _, vjp = jax.vjp(lambda a: seq_split(a, "model", 1), v)
        return vjp(scale(c))[0][None]

    def merge_bwd(v, c):
        _, vjp = jax.vjp(lambda a: seq_merge(a, "model", 1), v)
        return vjp(scale(c))[0]

    res["split"] = run(lambda v: seq_split(v, "model", 1), P(), seqd, x)
    res["split_bwd"] = run(split_bwd, (P(), seqd), stacked, x, g)
    res["merge"] = run(lambda v: seq_merge(v, "model", 1)[None], seqd, stacked, x)
    res["merge_bwd"] = run(merge_bwd, (seqd, P()), seqd, x, g)

    # two steps of each plan, from the same weights and batches
    nrt = jcfg.num_groups + 1
    shapes = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
              "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    opt = SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4)
    for label, kw in PLANS:
        plan = JPlan.build(nrt, round_to=2, **kw)
        with mesh:
            # the same function without its donation (ROADMAP reference caveats)
            step = jax.jit(make_train_step(jcfg, mcfg, mesh, spec, opt, shapes,
                                           plan=plan).__wrapped__)
            st = tree_to_storage(params, spec, mcfg)
            mom = init_momentum(st)
            for i in range(STEPS):
                tokens, labels = j_batch(jcfg.vocab_size, B, S, i)
                key = (jax.random.PRNGKey(i),) if plan.needs_rng else ()
                st, mom, m = step(st, mom, {"tokens": tokens, "labels": labels}, LR, *key)
                res[f"{label}/loss/{i}"] = np.asarray(m["loss"])
                res[f"{label}/norms/{i}"] = np.asarray(m["group_norms_sq"])
        for k, v in _paths(st).items():
            for r, blk in _shards(v, mesh, leaf_partition_spec(specs[k], mcfg)).items():
                res[f"{label}/final/{r}{k}"] = blk

    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------


def _port_rank(rank, inputs):
    """Everything the port computes on one rank of the 2×2 mesh, as numpy."""
    from repro_torch.convert import convert_lm_params
    from repro_torch.core import collectives as C
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.dist import comm
    from repro_torch.dist.spec import (
        MeshCfg, build_spec_tree, storage_shape, tree_to_local, tree_to_storage,
    )
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.models.init import init_params
    from repro_torch import random as tr
    from repro_torch.optim.sgd import SGDConfig, init_momentum
    from repro_torch.train.step import make_train_step, step_wire_table
    from repro_torch.transport import CompressionPolicy
    from repro_torch.transport import transport as T

    out = {}
    _, tcfg = _cfgs()
    mcfg = MeshCfg(tp=TP, dp=DP)
    mesh = make_mesh_from_cfg(mcfg)
    group = mesh.model
    m = torch.distributed.get_rank(group)
    params = convert_lm_params(tcfg, _params(inputs), device="cpu", tp=TP)
    _, metas = init_params(tcfg, device="meta", tp=TP)
    spec = build_spec_tree(params, metas, mcfg)
    storage = tree_to_storage(params, spec, mcfg)
    specs = _paths(spec)
    for k, v in _paths(tree_to_local(storage, spec, mcfg, rank)).items():
        out[f"shard{k}"] = v.numpy()
    if rank == 0:
        for k, v in _paths(storage).items():
            out[f"storage{k}"] = v.numpy()
            out[f"storage_shape{k}"] = np.array(storage_shape(specs[k], mcfg))

    # the activation path over the model group
    x, g = torch.from_numpy(inputs["act"]), torch.from_numpy(inputs["cot"])
    half = S // TP
    xs, gs = x[:, m * half:(m + 1) * half], g[:, m * half:(m + 1) * half]
    for rt, mode in ACT_CASES:
        pol = CompressionPolicy(**_policy_kw(rt, mode))
        gpol = CompressionPolicy(round_to=4, grad_round_to=rt, grad_mode=mode)
        tag = f"{rt}/{mode}"
        out[f"ar/{tag}"] = T.all_reduce(x * (m + 1.0), group, pol).numpy()
        out[f"ar_grad/{tag}"] = T.all_reduce(x * (m + 1.0), group, gpol,
                                             use_grad_format=True).numpy()
        a = xs.clone().requires_grad_(True)
        full = T.seq_gather(a, group, pol, 1)
        full.backward(g * (m + 1.0))
        out[f"sg/{tag}"], out[f"sg_bwd/{tag}"] = full.detach().numpy(), a.grad.numpy()
        a = (x * (m + 1.0)).requires_grad_(True)
        shard = T.seq_scatter(a, group, pol, 1)
        shard.backward(gs)
        out[f"ss/{tag}"], out[f"ss_bwd/{tag}"] = shard.detach().numpy(), a.grad.numpy()

    # the lossless sequence split and merge, through the Env of a
    # sequence-parallel plan
    env = PrecisionPlan.build(3, seq_parallel=True).make_env(mcfg, mesh)
    assert env.seq_parallel_active and env.model_rank() == m and env.ff_local(512) == 256
    assert env.without_seq_parallel().seq_shard(x) is x
    a = x.clone().requires_grad_(True)
    shard = env.seq_shard(a)
    shard.backward(gs * (m + 1.0))
    out["split"], out["split_bwd"] = shard.detach().numpy(), a.grad.numpy()
    a = xs.clone().requires_grad_(True)
    full = env.seq_unshard(a)
    full.backward(g * (m + 1.0))
    out["merge"], out["merge_bwd"] = full.detach().numpy(), a.grad.numpy()

    # a TP MLP through the f/g pair against the one-device gradient
    mx = torch.from_numpy(inputs["mlp_x"])
    w1, w2 = torch.from_numpy(inputs["mlp_w1"]), torch.from_numpy(inputs["mlp_w2"])
    cols = w1.shape[1] // TP
    for tag, pol in (("fp32", None), ("act2", CompressionPolicy(**_policy_kw(2, "nearest")))):
        a = w1[:, m * cols:(m + 1) * cols].clone().requires_grad_(True)
        b = w2[m * cols:(m + 1) * cols].clone().requires_grad_(True)
        xin = C.tp_region_enter(mx.clone().requires_grad_(True), group, pol)
        y = C.tp_region_exit(torch.relu(xin @ a) @ b, group, pol)
        loss = torch.sum(y ** 2)
        loss.backward()
        out[f"mlp/{tag}"] = (loss.item(), a.grad.numpy(), b.grad.numpy())

    # two steps of each plan, from the same weights and batches
    nrt = tcfg.num_groups + 1
    opt = SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4)
    for label, kw in PLANS:
        plan = PrecisionPlan.build(nrt, round_to=2, **kw)
        step = make_train_step(tcfg, mcfg, mesh, spec, opt, {"tokens": (B, S),
                                                             "labels": (B, S)}, plan=plan)
        st = jax.tree_util.tree_map(torch.clone, tree_to_local(storage, spec, mcfg, rank))
        mom = init_momentum(st)
        for i in range(STEPS):
            tokens, labels = synthetic_lm_batch(tcfg.vocab_size, B, S, i, device="cpu")
            first = len(comm.LOG)
            key = (tr.PRNGKey(i),) if plan.needs_rng else ()
            st, mom, met = step(st, mom, {"tokens": tokens, "labels": labels}, LR, *key)
            out[f"{label}/loss/{i}"] = met["loss"].numpy()
            out[f"{label}/norms/{i}"] = met["group_norms_sq"].numpy()
            out[f"{label}/wire/{i}"] = comm.wire_by_traffic(comm.LOG[first:])
        out[f"{label}/table"] = step_wire_table(plan, tcfg, spec, mcfg, (B, S))
        for k, v in _paths(st).items():
            out[f"{label}/final{k}"] = v.numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, [per-rank port outputs], inputs): the reference
    subprocess runs while the port's ranks do."""
    from repro_torch.launch.mesh import spawn_ranks

    tmp = tmp_path_factory.mktemp("tp")
    inputs = _inputs()
    inp, out = str(tmp / "inputs.npz"), str(tmp / "ref.npz")
    np.savez(inp, **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), inp, out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = spawn_ranks(_port_rank, TP * DP, inputs)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference failed:\n{stdout[-3000:]}\n{stderr[-3000:]}"
    return dict(np.load(out)), port, inputs


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# storage layout
# ---------------------------------------------------------------------------


def test_storage_layout_and_shards_equal_reference(runs):
    """``tree_to_storage`` at tp 2 × dp 2 (TP slice first, then flatten,
    then pad; stacked leaves ``(reps, tp, pad_rep)``): the reference's
    shapes and bytes; ``local_shard`` of every rank byte-equal to the
    block the reference's partition spec gives its device."""
    ref, port, _ = runs
    keys = [k[len("storage"):] for k in port[0] if k.startswith("storage") and
            not k.startswith("storage_shape")]
    assert len(keys) == 25  # 11 a layer group, embed, head, final norm
    for k in keys:
        want = ref[f"storage{k}"]
        assert tuple(port[0][f"storage_shape{k}"]) == want.shape, k
        np.testing.assert_array_equal(_bits(port[0][f"storage{k}"]), _bits(want), k)
        for r, p in enumerate(port):
            np.testing.assert_array_equal(_bits(p[f"shard{k}"]), _bits(ref[f"shard/{r}{k}"]),
                                          f"rank {r} {k}")


def test_storage_kinds_and_tp_slices():
    """The spec tree at tp 2: every matrix ``DIST``, TP-sliced along its
    ``tp_dim`` (the heads, ``d_ff`` and the vocabulary split in two); the
    norms ``REPL``; ``tp_slice`` of a leaf is what its model rank's blocks
    hold once gathered."""
    from repro_torch.dist.spec import (
        DIST, REPL, MeshCfg, build_spec_tree, leaf_to_local, tp_slice,
    )
    from repro_torch.models.init import init_params

    _, tcfg = _cfgs()
    mcfg = MeshCfg(tp=TP, dp=DP)
    params, metas = init_params(tcfg, 3, device="cpu", tp=TP)
    spec = build_spec_tree(params, metas, mcfg)
    kinds = {k: s.kind for k, s in _paths(spec).items()}
    assert {k for k, v in kinds.items() if v == REPL} == {
        k for k in kinds if k.endswith(("['ln']", "norm']"))}
    wq = spec["groups"][0]["p0"]["attn"]["wq"]
    assert (wq.kind, wq.logical, wq.local_logical) == (DIST, (256, 256), (256, 128))
    assert spec["embed"].local_logical == (256, 256)
    for name in ("wq", "wo", "wk"):
        s = spec["groups"][1]["p0"]["attn"][name]
        x = params["groups"][1]["p0"]["attn"][name]
        for r in range(TP * DP):
            m, f = r % TP, r // TP
            blocks = [leaf_to_local(x, s, mcfg, f2 * TP + m) for f2 in range(DP)]
            whole = torch.cat(blocks, -1).reshape(s.reps, -1)[:, :s.n_local]
            assert s.kind == DIST and torch.equal(
                whole, tp_slice(x, s, mcfg, m).reshape(s.reps, -1)), (name, r)


# ---------------------------------------------------------------------------
# the activation path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rt,mode", ACT_CASES, ids=[f"{rt}-{m}" for rt, m in ACT_CASES])
def test_activation_transport_bit_equal_reference(runs, rt, mode):
    """``all_reduce`` (forward and grad formats: a packed reduce-scatter
    and all-gather along the rightmost divisible dim, or the plain
    all-reduce at 4), ``seq_gather`` and ``seq_scatter`` with their
    backwards, over a 2-rank model group: the reference's bits on each
    model rank."""
    ref, port, _ = runs
    tag = f"{rt}/{mode}"
    for r, p in enumerate(port):
        m = r % TP
        for name in ("ar", "ar_grad", "sg", "ss_bwd"):
            np.testing.assert_array_equal(_bits(p[f"{name}/{tag}"]), _bits(ref[f"{name}/{tag}"][m]),
                                          f"{name} rank {r}")
        for name in ("sg_bwd", "ss"):
            half = S // TP
            want = ref[f"{name}/{tag}"][:, m * half:(m + 1) * half]
            np.testing.assert_array_equal(_bits(p[f"{name}/{tag}"]), _bits(want),
                                          f"{name} rank {r}")


def test_sequence_split_and_merge_bit_equal_reference(runs):
    """``Env.seq_shard`` / ``seq_unshard`` (``seq_split`` / ``seq_merge``):
    a replicated activation sliced to the rank's sequence shard with an
    all-gathered cotangent, and back; the reference's bits on each model
    rank."""
    ref, port, _ = runs
    half = S // TP
    for r, p in enumerate(port):
        m = r % TP
        for name in ("split_bwd", "merge"):
            np.testing.assert_array_equal(_bits(p[name]), _bits(ref[name][m]), f"{name} {r}")
        for name in ("split", "merge_bwd"):
            np.testing.assert_array_equal(_bits(p[name]),
                                          _bits(ref[name][:, m * half:(m + 1) * half]),
                                          f"{name} {r}")


def test_transport_falls_back_by_the_reference_rule():
    """``pick_split_axis`` is the reference's: the rightmost dim the group
    size divides, else none (the plain all-reduce)."""
    from repro.transport.transport import pick_split_axis as j_pick
    from repro_torch.transport.transport import pick_split_axis

    for shape in ((4, 32, 64), (3, 5), (4, 3), (1,), (2, 1), (6, 7, 9), ()):
        for n in (2, 3, 4):
            assert pick_split_axis(shape, n) == j_pick(shape, n), (shape, n)


def test_tp_mlp_gradient_equals_one_device(runs):
    """The reference's ``tp_mlp`` case (``scenario_compressed_collectives``):
    column-parallel then row-parallel weights between ``tp_region_enter``
    and ``tp_region_exit``; loss and the local gradients equal the
    one-device ones (fp32: rtol 1e-5; packed at round_to 2 nearest: the
    scenario's bounds)."""
    _, port, inputs = runs
    x = torch.from_numpy(inputs["mlp_x"])
    w1 = torch.from_numpy(inputs["mlp_w1"]).requires_grad_(True)
    w2 = torch.from_numpy(inputs["mlp_w2"]).requires_grad_(True)
    loss = torch.sum((torch.relu(x @ w1) @ w2) ** 2)
    loss.backward()
    cols = w1.shape[1] // TP
    for tag, rtol, atol, grad_rtol in (("fp32", 1e-5, 0.0, 1e-5), ("act2", 2e-2, 5e-2, 0.1)):
        for r, p in enumerate(port):
            m = r % TP
            got, ga, gb = p[f"mlp/{tag}"]
            np.testing.assert_allclose(got, loss.item(), rtol=rtol)
            np.testing.assert_allclose(ga, w1.grad[:, m * cols:(m + 1) * cols].numpy(),
                                       rtol=grad_rtol, atol=atol or 1e-6)
            np.testing.assert_allclose(gb, w2.grad[m * cols:(m + 1) * cols].numpy(),
                                       rtol=grad_rtol, atol=atol or 1e-6)


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", [p[0] for p in PLANS])
def test_train_steps_match_reference(runs, label):
    """Two steps at 2×2 from the same weights and batches: losses within
    ``LOSS_RTOL`` (else 1e-5) and per-group Σw² within rtol 1e-5 of the
    reference's and equal on every rank; each rank's updated blocks within ``UPDATE_BOUNDS`` of the
    reference's blocks for its device."""
    ref, port, _ = runs
    for i in range(STEPS):
        for p in port:
            np.testing.assert_allclose(p[f"{label}/loss/{i}"], ref[f"{label}/loss/{i}"],
                                       rtol=LOSS_RTOL.get(label, 1e-5))
            np.testing.assert_allclose(p[f"{label}/norms/{i}"], ref[f"{label}/norms/{i}"],
                                       rtol=1e-5)
            assert p[f"{label}/loss/{i}"] == port[0][f"{label}/loss/{i}"]
            np.testing.assert_array_equal(p[f"{label}/norms/{i}"], port[0][f"{label}/norms/{i}"])
    atol, rel = UPDATE_BOUNDS[label]
    for r, p in enumerate(port):
        for k in [k for k in p if k.startswith(f"{label}/final")]:
            path = k[len(label) + 6:]
            want, start = ref[f"{label}/final/{r}{path}"], ref[f"shard/{r}{path}"]
            gap = np.abs(p[k] - want)
            assert gap.max() <= atol, (k, r, gap.max())
            assert np.linalg.norm(p[k] - want) <= rel * np.linalg.norm(want - start), (k, r)


def test_accum_two_equals_accum_one_within_scenario_bars(runs):
    """``scenario_perf_levers.py`` on the 2×2 mesh: the losses of two
    steps at ``accum_steps`` 2 against the same plan's at 1 (``rt2``),
    within 2e-4 and 2e-3."""
    _, port, _ = runs
    for p in port:
        one = [float(p[f"rt2/loss/{i}"]) for i in range(STEPS)]
        two = [float(p[f"accum/loss/{i}"]) for i in range(STEPS)]
        assert abs(one[0] - two[0]) < 2e-4 and abs(one[1] - two[1]) < 2e-3, (one, two)


def test_seq_parallel_gives_the_psum_layout_bit_for_bit(runs):
    """Inside the port, as in the reference: the sequence-parallel layout's
    losses, norms and updated weights are the psum layout's bits."""
    _, port, _ = runs
    for p in port:
        keys = [k for k in p if k.startswith("rt2/") and "/wire/" not in k
                and not k.endswith("/table")]
        assert len(keys) > 2 * STEPS
        for k in keys:
            np.testing.assert_array_equal(_bits(p[k]), _bits(p["seq" + k[3:]]), k)


@pytest.mark.parametrize("label", [p[0] for p in PLANS])
def test_measured_wire_equals_step_wire_table(runs, label):
    """Every rank's collectives, logged per traffic class, equal the
    plan's ``wire_table`` with the step's TP boundaries
    (``step_wire_table``) at every step; the classes the plan does not
    price are the fp32 grad sync and metrics and the loss's reductions."""
    _, port, _ = runs
    for p in port:
        table = p[f"{label}/table"]
        for i in range(STEPS):
            wire = p[f"{label}/wire/{i}"]
            for k in ("weights", "gradients", "activations", "seq_boundary"):
                assert wire.get(k, 0) == table[k], (label, i, k, wire, table)
            seq = label == "seq"
            assert bool(wire.get("seq_boundary")) == seq and bool(wire.get("activations")) != seq
            assert set(wire) - {"weights", "gradients", "activations", "seq_boundary"} == {
                "grad_sync", "metrics", "loss"}


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
