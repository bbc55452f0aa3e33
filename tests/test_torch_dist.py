"""Data-parallel A²DTWP across gloo ranks: the port against the JAX reference.

The reference's outputs come from one subprocess of this file (``python
tests/test_torch_dist.py INPUTS OUT``) run with 4 emulated host devices,
as ``tests/test_distributed.py`` runs its scenarios, calling only what the
green scenarios call: ``Transport.all_gather`` / ``reduce_scatter`` and the
plane pack + tiled gather (``scenario_transport.py``), the chunked gather,
``make_cnn_train_step`` on reduced AlexNet with ``compress_min_size=256``
(``scenario_plan.py``'s CNN case) and the example launcher with
``--devices 2``. The port's side runs as 2 and 4 gloo ranks, processes
spawned by ``repro_torch.launch.mesh.spawn_ranks`` (one CPU thread each).
Every input is numpy from a seed, made once in this process.

Tolerances: planes, gathers, chunked gathers, storage layouts and wire
bytes must be equal (bit for bit, byte for byte). The ``grad_round_to=2``
reduce-scatter is bit-equal as well (the contributions are summed in rank
order on both sides); at ``grad_round_to=4`` the port's transport is
bit-equal to its own fp32 reduce-scatter (the reference's pin,
``scenario_transport.py``) and within rtol 1e-6 of the reference's.
Three ``oracle:2`` data-parallel steps of reduced AlexNet hold losses to
rtol 1e-4 and ``group_norms_sq`` to rtol 1e-4 of the reference's, and the
updated weights to atol 1e-5 (``test_torch_cnn.py``'s bar: fp32
convolutions summed in another order by XLA and oneDNN); with
``grad_round_to=2`` see ``GRAD2_FLIPS``. Seen on the CPU: losses within
1.6e-7 and Σw² within 1.4e-7 relative, weights within 4.3e-6 (dp 2) and
3.0e-8 (dp 4).
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.plan import PrecisionPlan as JPlan
from repro.transport.policy import CompressionPolicy as JPolicy
from repro.transport.policy import ring_wire_bytes as j_ring_wire_bytes
from repro_torch.plan import PrecisionPlan
from repro_torch.transport.policy import CompressionPolicy, ring_wire_bytes

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DPS = (2, 4)
S = 4 * 1024  # the flat weight the transport cases gather
CHUNKS = (2, 4)
# (shape, scatter axis): a stacked leaf's (reps, flat) at axis 1 and a 3-D
# array with trailing dims that do not divide (scenario_transport.py)
RS_CASES = (((3, 1024), 1), ((64, 5, 3), 0))
MIN_SIZE = 256  # the example's compress_min_size for the mini-nets
LR = 0.01
BATCH = 32
STEPS = 3
# (dp, pods, grad_round_to) of the data-parallel CNN runs; "2s" is
# grad_round_to 2 with stochastic rounding (the step's key folded as the
# reference folds it)
DP_RUNS = ((2, 1, None), (4, 1, None), (2, 1, 2), (2, 1, "2s"))
# At grad_round_to=2 each rank's gradient block is rounded to bf16
# (nearest) before the exchange: a gradient that lies within fp32
# summation noise of a rounding midpoint lands one bf16 step (2^-8
# relative) apart in the two packages, and momentum carries that into the
# weight. Seen: 3 of 101,314 weights more than 1e-5 apart (at most 1.3e-5,
# after 3 steps at lr 0.01). So there the updated weights are held to atol
# 1e-4, and at most this share of them may be more than 1e-5 apart.
GRAD2_FLIPS = 1e-3
LAUNCH = ["--steps", "3", "--batch", "16"]


def _grad_kw(grt) -> dict:
    """``PrecisionPlan.build`` keywords of a ``DP_RUNS`` gradient entry."""
    if grt == "2s":
        return {"grad_round_to": 2, "grad_mode": "stochastic"}
    return {"grad_round_to": grt}
# The reference's jitted data-parallel CNN step donates its storage, and at
# dp=2 XLA:CPU (jax 0.9.0) refuses that donation for reduced AlexNet
# ("Expected aliased input 5 ... to have the same size"; ROADMAP reference
# caveats). So the reference's steps run through ``jax.jit`` of the same
# function without donation, and its launcher runs at 4 devices (the
# figures the test compares do not depend on the device count).
LAUNCH_DEVICES = {"port": 2, "reference": 4}


# ---------------------------------------------------------------------------
# inputs (this process) and the reference (a subprocess of this file)
# ---------------------------------------------------------------------------


def _cnn_cfgs():
    from repro.models import cnn as jc
    from repro_torch.models import cnn as tc

    return (jc.reduced_cnn(jc.ALEXNET, num_classes=10, in_hw=32),
            tc.reduced_cnn(tc.ALEXNET, num_classes=10, in_hw=32))


def _reference_metas(jcfg):
    """``repro.models.cnn.init_cnn``'s metas and group map, with no draw
    run (``jax.eval_shape``)."""
    import jax

    from repro.models import cnn as jc

    box = {}

    def init(key):
        params, box["metas"], box["gi"] = jc.init_cnn(jcfg, key)
        return params

    jax.eval_shape(init, jax.random.PRNGKey(0))
    return box["metas"], box["gi"]


def _inputs() -> dict:
    """numpy inputs from seeds; reference-layout AlexNet weights drawn at
    ``repro.models.cnn.init_cnn``'s shapes and scales (He init)."""
    import jax

    from repro.models import cnn as jc

    rng = np.random.default_rng(0)
    out = {"w": rng.normal(0, 1, (S,)).astype(np.float32)}
    for i, (shape, _) in enumerate(RS_CASES):
        out[f"rs{i}"] = rng.normal(0, 1, shape).astype(np.float32)
    jcfg, _ = _cnn_cfgs()
    shapes = jax.eval_shape(lambda k: jc.init_cnn(jcfg, k)[0], jax.random.PRNGKey(0))
    wrng = np.random.default_rng(1)
    for name, leafs in shapes["layers"].items():
        for k, s in leafs.items():
            if k == "w":
                std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
                a = (std * wrng.standard_normal(s.shape)).astype(np.float32)
            else:
                a = np.full(s.shape, 0.1, np.float32)  # AlexNet's biases
            out[f"cnn/{name}/{k}"] = a
    return out


def _cnn_tree(inputs) -> dict:
    layers: dict = {}
    for key, a in inputs.items():
        if key.startswith("cnn/"):
            _, name, k = key.split("/")
            layers.setdefault(name, {})[k] = a
    return {"layers": layers}


def _reference(inputs_path, out_path):
    """The reference's outputs (4 emulated host devices)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.data.pipeline import SyntheticImageNet as JData
    from repro.dist.shard import shard_map
    from repro.dist.spec import MeshCfg as JMesh
    from repro.dist.spec import storage_shape as j_storage_shape
    from repro.launch.mesh import make_mesh_from_cfg
    from repro.optim.sgd import SGDConfig as JSGD
    from repro.optim.sgd import init_momentum
    from repro.train import cnn_step as jstep
    from repro.transport import Transport
    from repro.transport import transport as jT

    inputs = dict(np.load(inputs_path))
    res, text = {}, {}
    devs = np.array(jax.devices())
    w = jnp.asarray(inputs["w"])
    for D in DPS:
        mesh = Mesh(devs[:D], ("data",))
        t = Transport("data")

        def run(f, x, out_spec=P(None)):
            return np.asarray(jax.jit(shard_map(f, mesh=mesh, in_specs=P("data"),
                                                out_specs=out_spec))(x))

        for rt in (1, 2, 3, 4):
            res[f"planes/{D}/{rt}"] = run(
                lambda x, rt=rt: lax.all_gather(jT.pack_planes(x, rt), "data", axis=1,
                                                tiled=True), w, P(None, None))
            res[f"gather/{D}/{rt}"] = run(
                lambda x, rt=rt: t.all_gather(x, JPolicy(round_to=rt)), w)
        for c in CHUNKS:
            res[f"chunked/{D}/{c}"] = run(
                lambda x, c=c: t.all_gather(x, JPolicy(round_to=2, chunks=c)), w)
        for i, (shape, axis) in enumerate(RS_CASES):
            spec = P(*["data" if d == axis else None for d in range(len(shape))])
            for rt in (2, 4):
                def rs(g, axis=axis, rt=rt):
                    r = lax.axis_index("data")
                    return t.reduce_scatter(g * (r + 1.0), JPolicy(grad_round_to=rt),
                                            axis=axis)
                f = shard_map(rs, mesh=mesh, in_specs=P(*[None] * len(shape)),
                              out_specs=spec)
                res[f"rs/{D}/{i}/{rt}"] = np.asarray(jax.jit(f)(jnp.asarray(inputs[f"rs{i}"])))

    jcfg, _ = _cnn_cfgs()
    metas, gi = _reference_metas(jcfg)
    tree = _cnn_tree(inputs)
    for D in DPS:
        mcfg = JMesh(tp=1, dp=D, compress_min_size=MIN_SIZE)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        spec = jstep.build_cnn_spec_tree(params, metas, mcfg)
        storage = jstep.cnn_to_storage(params, spec, mcfg)
        for name, leafs in storage["layers"].items():
            for k, v in leafs.items():
                res[f"storage/{D}/{name}/{k}"] = np.asarray(v)
                text[f"storage_shape/{D}/{name}/{k}"] = list(
                    j_storage_shape(spec["layers"][name][k], mcfg))

    data = JData(num_classes=jcfg.num_classes, hw=jcfg.in_hw, noise=0.1)
    for D, pods, grt in DP_RUNS:
        mcfg = JMesh(tp=1, dp=D, pods=pods, compress_min_size=MIN_SIZE)
        mesh = make_mesh_from_cfg(mcfg)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        spec = jstep.build_cnn_spec_tree(params, metas, mcfg)
        st = jstep.cnn_to_storage(params, spec, mcfg)
        plan = JPlan.build(gi[1], round_to=2, **_grad_kw(grt))
        with mesh:
            step = jax.jit(jstep.make_cnn_train_step(
                jcfg, mcfg, mesh, spec, gi, JSGD(lr=LR, momentum=0.9, weight_decay=5e-4),
                {}, plan=plan).__wrapped__)
            mom = init_momentum(st)
            for i in range(STEPS):
                imgs, labels = data.batch(BATCH, i)
                st, mom, m = step(st, mom, {"images": imgs, "labels": labels}, LR,
                                  jax.random.PRNGKey(1000 + i))
                res[f"dp/{D}/{grt}/loss/{i}"] = np.asarray(m["loss"])
                res[f"dp/{D}/{grt}/norms/{i}"] = np.asarray(m["group_norms_sq"])
        for name, leafs in st["layers"].items():
            for k, v in leafs.items():
                res[f"dp/{D}/{grt}/final/{name}/{k}"] = np.asarray(v)

    # the example launcher, data-parallel over 2 devices
    import runpy
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = ["awp_cnn_repro.py", "--devices", str(LAUNCH_DEVICES["reference"]), *LAUNCH]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(ROOT, "examples", "awp_cnn_repro.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
    text["launcher"] = buf.getvalue()
    np.savez(out_path, **res)
    with open(out_path + ".json", "w") as f:
        json.dump(text, f)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------


def _port_rank(rank, D, inputs):
    """Everything the port computes on a ``D``-rank gloo group, as numpy:
    replicated results from rank 0, per-rank blocks from every rank."""
    from repro_torch.convert import convert_cnn_params
    from repro_torch.data.pipeline import SyntheticImageNet
    from repro_torch.dist import comm
    from repro_torch.dist.spec import MeshCfg, storage_shape, tree_to_local
    from repro_torch.kernels.ops import bitpack
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.models.cnn import init_cnn
    from repro_torch.optim.sgd import SGDConfig, init_momentum
    from repro_torch import random as jr
    from repro_torch.train import cnn_step as tstep
    from repro_torch.transport import transport as T

    out, n = {}, S // D
    w = torch.from_numpy(inputs["w"])
    local = w[rank * n:(rank + 1) * n]
    t = T.Transport(None)
    for rt in (1, 2, 3, 4):
        planes = bitpack(local, rt)
        out[f"planes/{rt}"] = comm.all_gather(planes, None, axis=1, traffic="weights").numpy()
        out[f"gather/{rt}"] = t.all_gather(local, CompressionPolicy(round_to=rt)).numpy()
    for c in CHUNKS:
        out[f"chunked/{c}"] = t.all_gather(
            local, CompressionPolicy(round_to=2, chunks=c)).numpy()
    for i, (_, axis) in enumerate(RS_CASES):
        g = torch.from_numpy(inputs[f"rs{i}"]) * (rank + 1.0)
        for rt in (2, 4):
            out[f"rs/{i}/{rt}"] = t.reduce_scatter(
                g, CompressionPolicy(grad_round_to=rt), axis=axis).numpy()
        out[f"rs_fp32/{i}"] = comm.reduce_scatter(g, None, axis=axis, traffic="gradients").numpy()

    _, tcfg = _cnn_cfgs()
    _, metas, gi = init_cnn(tcfg, 0, device="meta")
    tree = _cnn_tree(inputs)
    mcfg = MeshCfg(dp=D, compress_min_size=MIN_SIZE)
    params = convert_cnn_params(tcfg, tree, device="cpu")
    spec = tstep.build_cnn_spec_tree(params, metas, mcfg)
    storage = tstep.cnn_to_storage(params, spec, mcfg)
    for name, leafs in storage["layers"].items():
        for k, v in leafs.items():
            out[f"storage/{name}/{k}"] = v.numpy()
            out[f"storage_shape/{name}/{k}"] = np.array(
                storage_shape(spec["layers"][name][k], mcfg))

    data = SyntheticImageNet(num_classes=tcfg.num_classes, hw=tcfg.in_hw, noise=0.1,
                             device="cpu")
    runs = [r for r in DP_RUNS if r[0] == D] + ([(2, 2, None)] if D == 4 else [])
    for dp, pods, grt in runs:
        mcfg = MeshCfg(dp=dp, pods=pods, compress_min_size=MIN_SIZE)
        mesh = make_mesh_from_cfg(mcfg)
        params = convert_cnn_params(tcfg, tree, device="cpu")
        spec = tstep.build_cnn_spec_tree(params, metas, mcfg)
        st = tree_to_local(tstep.cnn_to_storage(params, spec, mcfg), spec, mcfg, rank)
        plan = PrecisionPlan.build(gi[1], round_to=2, **_grad_kw(grt))
        step = tstep.make_cnn_train_step(
            tcfg, mcfg, spec, gi, SGDConfig(lr=LR, momentum=0.9, weight_decay=5e-4),
            plan=plan, mesh=mesh)
        mom = init_momentum(st)
        tag = f"dp/{dp}x{pods}/{grt}"
        first = len(comm.LOG)
        for i in range(STEPS):
            imgs, labels = data.batch(BATCH, i)
            st, mom, m = step(st, mom, {"images": imgs, "labels": labels}, LR,
                              jr.PRNGKey(1000 + i))
            out[f"{tag}/loss/{i}"] = m["loss"].numpy()
            out[f"{tag}/norms/{i}"] = m["group_norms_sq"].numpy()
        out[f"{tag}/wire"] = comm.wire_by_traffic(comm.LOG[first:])
        for name, leafs in st["layers"].items():
            for k, v in leafs.items():
                out[f"{tag}/final/{name}/{k}"] = v.numpy()
        if grt == "2s":  # a second run from the same state: the same bits
            st2 = tree_to_local(tstep.cnn_to_storage(params, spec, mcfg), spec, mcfg, rank)
            mom2 = init_momentum(st2)
            for i in range(STEPS):
                imgs, labels = data.batch(BATCH, i)
                st2, mom2, m = step(st2, mom2, {"images": imgs, "labels": labels}, LR,
                                    jr.PRNGKey(1000 + i))
                out[f"{tag}/again/loss/{i}"] = m["loss"].numpy()
            for name, leafs in st2["layers"].items():
                for k, v in leafs.items():
                    out[f"{tag}/again/final/{name}/{k}"] = v.numpy()
        if dp == 2 and pods == 1 and grt is None:
            evaluate = tstep.make_cnn_eval(tcfg, mcfg, spec, gi, plan=plan, mesh=mesh)
            imgs, labels = data.validation(64)
            out[f"{tag}/top5"] = float(evaluate(st, imgs, labels))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, reference text, {D: [per-rank port outputs]},
    inputs): the reference subprocess runs while the port's ranks do."""
    tmp = tmp_path_factory.mktemp("dist")
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
        from repro_torch.launch.mesh import spawn_ranks

        port = {D: spawn_ranks(_port_rank, D, D, inputs) for D in DPS}
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference failed:\n{stdout[-3000:]}\n{stderr[-3000:]}"
    ref = dict(np.load(out))
    with open(out + ".json") as f:
        text = json.load(f)
    return ref, text, port, inputs


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", DPS)
@pytest.mark.parametrize("rt", [1, 2, 3, 4])
def test_gathered_planes_equal_reference(runs, D, rt):
    """Each rank packs its shard (Bitpack), the planes are gathered: byte
    for byte the reference's planes on every rank; the unpacked gather is
    bit-equal to the reference's ``Transport.all_gather``."""
    ref, _, port, _ = runs
    for r, got in enumerate(port[D]):
        np.testing.assert_array_equal(got[f"planes/{rt}"], ref[f"planes/{D}/{rt}"], f"rank {r}")
        assert got[f"gather/{rt}"].view(np.uint32).tolist() == \
            ref[f"gather/{D}/{rt}"].view(np.uint32).tolist()


@pytest.mark.parametrize("D", DPS)
@pytest.mark.parametrize("chunks", CHUNKS)
def test_chunked_gather_equals_unchunked_and_reference(runs, D, chunks):
    ref, _, port, _ = runs
    for got in port[D]:
        np.testing.assert_array_equal(got[f"chunked/{chunks}"].view(np.uint32),
                                      got["gather/2"].view(np.uint32))
        np.testing.assert_array_equal(got[f"chunked/{chunks}"].view(np.uint32),
                                      ref[f"chunked/{D}/{chunks}"].view(np.uint32))


def _assemble(blocks, axis):
    return np.concatenate(blocks, axis=axis)


@pytest.mark.parametrize("D", DPS)
@pytest.mark.parametrize("case", range(len(RS_CASES)), ids=["stacked-axis1", "3d-axis0"])
def test_reduce_scatter_matches_reference(runs, D, case):
    """``grad_round_to=2``: per-peer planes exchanged, unpacked and summed
    in fp32, bit-equal to the reference's; ``grad_round_to=4``: bit-equal
    to the port's own fp32 reduce-scatter and within rtol 1e-6 of the
    reference's ``psum_scatter``."""
    ref, _, port, _ = runs
    axis = RS_CASES[case][1]
    got2 = _assemble([p[f"rs/{case}/2"] for p in port[D]], axis)
    np.testing.assert_array_equal(got2.view(np.uint32), ref[f"rs/{D}/{case}/2"].view(np.uint32))
    for p in port[D]:
        np.testing.assert_array_equal(p[f"rs/{case}/4"].view(np.uint32),
                                      p[f"rs_fp32/{case}"].view(np.uint32))
    got4 = _assemble([p[f"rs/{case}/4"] for p in port[D]], axis)
    np.testing.assert_allclose(got4, ref[f"rs/{D}/{case}/4"], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# storage layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", DPS)
def test_storage_layout_matches_reference(runs, D):
    """``storage_shape`` and ``tree_to_storage`` (``cnn_to_storage``) of
    reduced AlexNet at dp 2 and 4: the same shapes; the same bytes in the
    ``DIST`` leaves' padded flat storage once the port's OIHW / NCHW layout
    is converted back, zero padding included; replicated leaves whole."""
    from repro_torch.convert import convert_cnn_params

    ref, text, port, inputs = runs
    _, tcfg = _cnn_cfgs()
    got = port[D][0]
    tree = _cnn_tree(inputs)
    logical = {}
    for name, leafs in tree["layers"].items():
        for k, a in leafs.items():
            key = f"{name}/{k}"
            assert got[f"storage_shape/{key}"].tolist() == text[f"storage_shape/{D}/{key}"], key
            want = ref[f"storage/{D}/{key}"]
            assert got[f"storage/{key}"].shape == want.shape, key
            logical.setdefault(name, {})[k] = want[:a.size].reshape(a.shape)
            if want.ndim == 1 and want.size > a.size:  # padded DIST storage
                assert not want[a.size:].any() and not got[f"storage/{key}"][a.size:].any()
    converted = convert_cnn_params(tcfg, {"layers": logical}, device="cpu")
    for name, leafs in converted["layers"].items():
        for k, v in leafs.items():
            flat = got[f"storage/{name}/{k}"].reshape(-1)[:v.numel()]
            np.testing.assert_array_equal(flat, v.numpy().reshape(-1), f"{name}/{k}")


# ---------------------------------------------------------------------------
# wire accounting
# ---------------------------------------------------------------------------


def test_ring_and_policy_wire_bytes_equal_reference():
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute", "all-gather-start"):
        for payload in (0, 1, 4096, 123_457, 88_936_448):
            for n in (1, 2, 3, 4, 8):
                assert ring_wire_bytes(kind, payload, n) == j_ring_wire_bytes(kind, payload, n)
    with pytest.raises(ValueError):
        ring_wire_bytes("broadcast", 1, 2)
    for rt in (1, 2, 3, 4):
        for grt in (1, 2, 3, 4):
            t, j = CompressionPolicy(rt, grt), JPolicy(rt, grt)
            assert (t.compresses, t.compresses_grads, t.bytes_per_element) == \
                (j.compresses, j.compresses_grads, j.bytes_per_element)
            for s_loc, n in ((1, 2), (1024, 4), (11_117_056, 8), (5, 3)):
                assert t.all_gather_wire_bytes(s_loc, n) == j.all_gather_wire_bytes(s_loc, n)
                assert t.reduce_scatter_wire_bytes(s_loc, n) == \
                    j.reduce_scatter_wire_bytes(s_loc, n)


def test_mesh_configs_match_reference():
    """``mesh_cfg_for`` gives the reference's production geometries; the
    trivial mesh has no ``DeviceMesh``; a sharded one needs the ranks'
    process group; ``local_shard`` at tp 2 takes the rank's block."""
    import dataclasses

    from repro.launch.mesh import mesh_cfg_for as j_mesh_cfg_for
    from repro_torch.dist.spec import MeshCfg, build_leaf_spec, leaf_to_storage, local_shard
    from repro_torch.launch.mesh import make_mesh_from_cfg, mesh_cfg_for
    from repro_torch.models.meta import ParamMeta

    for multi in (False, True):
        t, j = mesh_cfg_for(multi_pod=multi), j_mesh_cfg_for(multi_pod=multi)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.shape, t.axis_names, t.dshards) == (j.shape, j.axis_names, j.dshards)
    assert make_mesh_from_cfg(MeshCfg()) is None
    with pytest.raises(RuntimeError, match="initialised"):
        make_mesh_from_cfg(MeshCfg(tp=2))  # FSDP×TP meshes: tests/test_torch_tp.py
    # a TP-sliced DIST leaf at tp 2 × dp 2: rank (data f, model m) holds
    # half of model rank m's slice, flat, at f's offset
    mcfg = MeshCfg(tp=2, dp=2, compress_min_size=4)
    spec = build_leaf_spec((4, 6), ParamMeta(tp_dim=1), mcfg)
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    storage = leaf_to_storage(x, spec, mcfg)
    for r in range(4):
        f, m = divmod(r, 2)
        want = x[:, 3 * m:3 * m + 3].reshape(-1)[6 * f:6 * f + 6]
        assert torch.equal(local_shard(storage, spec, mcfg, r), want[None])


@pytest.mark.parametrize("kw", [
    dict(round_to=2), dict(round_to=1, grad_round_to=2), dict(round_to=3, chunks=4),
    dict(round_to=4, grad_round_to=3, grad_mode="truncate"),
], ids=["oracle2", "grad2", "chunks4", "grad3-truncate"])
def test_sharded_wire_table_equals_reference(kw):
    elems = [0, 307200, 663552, 1327104, 884736, 51380224, 16777216, 16777216, 819200]
    t, j = PrecisionPlan.build(9, **kw), JPlan.build(9, **kw)
    for n in (1, 2, 4, 8):
        for rts in ((1,) * 9, (2, 3, 4, 1, 2, 3, 4, 1, 2)):
            assert t.with_round_tos(rts).wire_table(elems, n) == \
                j.with_round_tos(rts).wire_table(elems, n), (n, rts)


# ---------------------------------------------------------------------------
# the data-parallel CNN step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", DP_RUNS, ids=["dp2", "dp4", "dp2-grad2", "dp2-grad2-stochastic"])
def test_dp_cnn_steps_match_reference(runs, run):
    """Three ``oracle:2`` steps of reduced AlexNet, data-parallel, from the
    same weights and batches: losses and per-group Σw² within rtol 1e-4 of
    the reference's, the same on every rank; the ranks' updated shards
    reassembled within atol 1e-5 of the reference's updated weights; the
    measured wire equal to the plan's ``wire_table`` per class."""
    from repro_torch.convert import convert_cnn_params

    ref, _, port, inputs = runs
    D, pods, grt = run
    ranks = port[D]
    tag = f"dp/{D}x{pods}/{grt}"
    for i in range(STEPS):
        for p in ranks:
            np.testing.assert_allclose(p[f"{tag}/loss/{i}"], ref[f"dp/{D}/{grt}/loss/{i}"],
                                       rtol=1e-4)
            np.testing.assert_allclose(p[f"{tag}/norms/{i}"], ref[f"dp/{D}/{grt}/norms/{i}"],
                                       rtol=1e-4)
            assert p[f"{tag}/loss/{i}"] == ranks[0][f"{tag}/loss/{i}"]
            if grt == "2s":  # a second run gives the same bits
                assert p[f"{tag}/again/loss/{i}"] == p[f"{tag}/loss/{i}"]
    if grt == "2s":
        for p in ranks:
            for k in [k for k in p if k.startswith(f"{tag}/final/")]:
                np.testing.assert_array_equal(p[k.replace("/final/", "/again/final/")], p[k])
    _, tcfg = _cnn_cfgs()
    tree = _cnn_tree(inputs)
    logical = {name: {k: ref[f"dp/{D}/{grt}/final/{name}/{k}"][:a.size].reshape(a.shape)
                      for k, a in leafs.items()} for name, leafs in tree["layers"].items()}
    want = convert_cnn_params(tcfg, {"layers": logical}, device="cpu")
    flips = total = 0
    for name, leafs in want["layers"].items():
        for k, v in leafs.items():
            parts = [p[f"{tag}/final/{name}/{k}"] for p in ranks]
            full = np.concatenate(parts) if parts[0].shape != v.shape else parts[0]
            gap = np.abs(full.reshape(-1)[:v.numel()] - v.numpy().reshape(-1))
            if grt is None:
                assert gap.max() <= 1e-5, (name, k, gap.max())
            else:  # see GRAD2_FLIPS
                assert gap.max() <= 1e-4, (name, k, gap.max())
                flips, total = flips + int((gap > 1e-5).sum()), total + gap.size
    assert flips <= GRAD2_FLIPS * total, (flips, total)
    # measured == analytic, per traffic class (the non-DIST psums are extra)
    from repro_torch.dist.spec import MeshCfg
    from repro_torch.models.cnn import init_cnn
    from repro_torch.train.cnn_step import build_cnn_spec_tree, cnn_dist_elems

    params, metas, gi = init_cnn(tcfg, 0, device="meta")
    mcfg = MeshCfg(dp=D, pods=pods, compress_min_size=MIN_SIZE)
    elems = cnn_dist_elems(build_cnn_spec_tree(params, metas, mcfg), gi, mcfg)
    table = PrecisionPlan.build(gi[1], round_to=2, **_grad_kw(grt)).wire_table(elems, D)
    wire = ranks[0][f"{tag}/wire"]
    for k in ("weights", "gradients"):
        assert wire[k] == STEPS * table[k], (k, wire, table)
    assert set(wire) == {"weights", "gradients", "grad_sync", "metrics"}


def test_pods_by_data_gives_the_bits_of_data_alone(runs):
    """pods 2 × dp 2 is one gather group of 4 ranks in the same order as
    dp 4: the same losses, norms and updated shards, bit for bit."""
    _, _, port, _ = runs
    for p in port[4]:
        keys = [k for k in p if k.startswith("dp/2x2/")]
        assert len(keys) > 2 * STEPS
        for k in keys:
            other = k.replace("dp/2x2/", "dp/4x1/")
            if k.endswith("/wire"):
                assert p[k] == p[other]
            else:
                np.testing.assert_array_equal(np.asarray(p[k]).view(np.uint32),
                                              np.asarray(p[other]).view(np.uint32), k)


def test_dp_eval_on_sharded_storage(runs):
    """``make_cnn_eval`` on the ranks' shards gathers the weights and gives
    every rank the same top-5 error."""
    _, _, port, _ = runs
    errs = {p["dp/2x1/None/top5"] for p in port[2]}
    assert len(errs) == 1 and 0.0 <= errs.pop() <= 1.0


# ---------------------------------------------------------------------------
# the launcher twin
# ---------------------------------------------------------------------------


def _figures(text):
    """The AWP line and every policy's wire-reduction figure."""
    awp = [line.strip() for line in text.splitlines() if "AWP bits history" in line]
    wire = [line.split("wire reduction")[1].split()[0] for line in text.splitlines()
            if "wire reduction" in line]
    total = [line.strip() for line in text.splitlines() if "weight-motion reduction" in line]
    return awp, wire, total[0].split("reduction:")[1].split()[0]


def test_launcher_twin_prints_reference_figures(runs, capsys):
    """``--devices 2`` on the CPU: two gloo ranks; the AWP line and the
    wire figures equal the reference launcher's for the same seed and
    arguments (with 3 steps no group widens: (8,)*9 bits; the reduction
    counts the gathered weights and the fp32 gradients, the same share at
    any device count)."""
    from repro_torch.launch import awp_cnn_repro

    _, text, _, _ = runs
    results = awp_cnn_repro.main(["--devices", str(LAUNCH_DEVICES["port"]), *LAUNCH,
                                  "--device", "cpu"])
    out = capsys.readouterr().out
    got, want = _figures(out), _figures(text["launcher"])
    assert got == want and got[0] == ["AWP bits history: [(0, (8, 8, 8, 8, 8, 8, 8, 8, 8))]"]
    assert got[1] == ["0.0%", "25.0%", "37.5%"]
    for r in results.values():
        assert r["steps"] == 3
        assert r["measured_by_entry"]["weights"] == r["wire_by_entry"]["weights"]
        assert r["measured_by_entry"]["gradients"] == r["wire_by_entry"]["gradients"]


def test_launcher_refuses_stochastic_gradients(capsys):
    """Refused until stochastic rounding was ported; now ``--grad-mode
    stochastic`` runs on two ranks: the stochastic gradient reduce-scatter
    moves its packed planes (the measured wire is the plan's), and two runs
    give the same losses bit for bit (the keys are the steps')."""
    from repro_torch.launch import awp_cnn_repro

    argv = ["--devices", "2", "--steps", "2", "--batch", "16", "--grad-round-to", "2",
            "--grad-mode", "stochastic", "--device", "cpu"]
    first = awp_cnn_repro.main(argv)
    again = awp_cnn_repro.main(argv)
    assert "wire reduction" in capsys.readouterr().out
    for policy, r in first.items():
        assert r["measured_by_entry"]["gradients"] == r["wire_by_entry"]["gradients"] > 0
        assert r["losses"] == again[policy]["losses"], policy


def test_chip_smoke_dp_phase_rehearses_on_cpu(monkeypatch, capsys):
    """``chip_smoke.py`` phase 12 at reduced width on the CPU: two gloo
    ranks (plain versions; launch counts, packing records and the profile
    are read on a card only) pass checks (a), (b), (d) and (e)."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke
    from repro_torch.models.cnn import ALEXNET, reduced_cnn

    out = chip_smoke.dp_train_path(torch, torch.device("cpu"),
                                   cfg=reduced_cnn(ALEXNET, num_classes=10, in_hw=32),
                                   batch=8, min_size=MIN_SIZE)
    assert out["loss_gap"] <= chip_smoke.DP_LOSS_RTOL
    assert out["norm_gap"] <= chip_smoke.DP_NORM_RTOL
    assert len(out["ranks"]) == chip_smoke.DP_RANKS
    text = capsys.readouterr().out
    assert text.count("(== wire_table)") == len(chip_smoke.DP_STEPS)


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
