"""FSDP×TP training of the MoE archs across gloo ranks: the port against
the JAX reference on a 2×2 mesh.

The reference runs in one subprocess of this file (``python
tests/test_torch_moe_mesh.py INPUTS OUT``) with 4 emulated host devices:
``make_train_step`` at ``MeshCfg(tp=2, dp=2)`` (the jitted function
without its donation, as ``tests/test_torch_tp.py`` runs it), two steps at
``round_to`` 2 from the reference's ``init_params(cfg, PRNGKey(0),
tp=2)`` weights, converted, on ``synthetic_lm_batch`` at B 8, S 32. The
port runs 4 gloo ranks (``spawn_ranks``, one CPU thread each). Configs:
reduced mixtral-8x7b (the ``tp`` layout: every expert's ``d_ff`` split over
the model ranks, dispatch local to the rank) and reduced arctic-480b (the
``ep`` layout at tp 2: 2 of its 4 experts a rank, the token split and the
expert exchanges, the dense residual). Each data rank routes its own rows
in both packages, so capacity drops see the same token sets. The
reference's MoE gradients are repaired in its process first, as in
``tests/test_torch_moe.py`` (ROADMAP Queue 3: the ``psum_enter`` before
its token split, and the aux loss taken whole on every model rank, make
those gradients ``tp`` times the one-device ones); the port makes neither
fault.

Tolerances: the losses (the aux term included) within rtol 1e-5, Σw²
within rtol 1e-5, every rank's updated shards within atol 1e-6 and a
relative l2 of the update of 1e-3 (fp32 sums in another order, as in
``tests/test_torch_tp.py``). One exception, the routing tie rule's: where
two of a token's router probabilities among its top ``k + 1`` are within
``TIE_GAP`` (1e-6, some 30 ulps at 0.28) in the port, their order may
differ in the reference, whose softmax is an ulp or so away (XLA's
``exp``), even though both break exact ties to the lower expert. A flip
inside the top ``k`` moves the aux's top-1 expert counts by ``1 / T`` for
two experts and so that layer's router gradient; its router update is
then held to a relative l2 of ``FLIP_REL`` (1e-2). Seen: mixtral, step 2,
layer 0, a token at 0.27916783 / 0.27916753 in the port (2.98e-7 apart,
expert 0 first) and 0.2791683 / 0.2791693 in the reference (expert 3
first), the router's update 1.16e-3 apart; every other leaf within 1e-3.
The near-ties are counted from the port's routing calls. Each rank's measured wire per priced class
equals ``step_wire_table`` exactly; the unpriced classes are the grad
sync, the metrics (the aux sums among them), the loss's reductions and,
under ``ep``, the ``relayout`` of the token split and the exchanges. The
port alone, with ``remat`` on, psum and sequence-parallel: the measured
wire equals the table's recomputed boundaries in both layouts.
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

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TP, DP = 2, 2
B, S, LR, STEPS = 8, 32, 0.05, 2
ARCHS = ("mixtral-8x7b", "arctic-480b")
LOSS_RTOL = NORM_RTOL = 1e-5
UPDATE_ATOL, UPDATE_REL = 1e-6, 1e-3
TIE_GAP, FLIP_REL = 1e-6, 1e-2  # see the module docstring
PRICED = ("weights", "gradients", "activations", "seq_boundary")


def _cfgs(arch):
    from repro_torch.configs.registry import get_config, reduced

    return j_reduced(j_get_config(arch)), reduced(get_config(arch))


def _paths(tree):
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _inputs() -> dict:
    out = {}
    for arch in ARCHS:
        jcfg, _ = _cfgs(arch)
        params, _ = j_init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
        out.update({f"{arch}/w{k}": np.asarray(v) for k, v in _paths(params).items()})
    return out


def _params(inputs, arch):
    jcfg, _ = _cfgs(arch)
    shapes = jax.eval_shape(lambda k: j_init_params(jcfg, k, tp=TP)[0], jax.random.PRNGKey(0))
    flat = [inputs[f"{arch}/w{k}"] for k in _paths(shapes)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), flat)


def _reference(inputs_path, out_path):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.data.pipeline import synthetic_lm_batch as j_batch
    from repro.dist.spec import MeshCfg as JMesh
    from repro.dist.spec import build_spec_tree, leaf_partition_spec, tree_to_storage
    from repro.launch.mesh import make_mesh_from_cfg
    from repro.optim.sgd import SGDConfig, init_momentum
    from repro.plan import PrecisionPlan as JPlan
    from repro.train.step import make_train_step
    from test_torch_moe import repair_reference

    repair_reference(TP)
    inputs = dict(np.load(inputs_path))
    res = {}
    mcfg = JMesh(tp=TP, dp=DP)
    mesh = make_mesh_from_cfg(mcfg)
    devs = list(mesh.devices.flat)
    shapes = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
              "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    opt = SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4)
    for arch in ARCHS:
        jcfg, _ = _cfgs(arch)
        params = jax.tree_util.tree_map(jnp.asarray, _params(inputs, arch))
        _, metas = j_init_params(jcfg, None, tp=TP)
        spec = build_spec_tree(params, metas, mcfg)
        specs = _paths(spec)
        plan = JPlan.build(jcfg.num_groups + 1, round_to=2)
        with mesh:
            step = jax.jit(make_train_step(jcfg, mcfg, mesh, spec, opt, shapes,
                                           plan=plan).__wrapped__)
            st = tree_to_storage(params, spec, mcfg)
            mom = init_momentum(st)
            for i in range(STEPS):
                tokens, labels = j_batch(jcfg.vocab_size, B, S, i)
                st, mom, m = step(st, mom, {"tokens": tokens, "labels": labels}, LR)
                res[f"{arch}/loss/{i}"] = np.asarray(m["loss"])
                res[f"{arch}/norms/{i}"] = np.asarray(m["group_norms_sq"])
        for k, v in _paths(st).items():
            placed = jax.device_put(v, NamedSharding(mesh, leaf_partition_spec(specs[k], mcfg)))
            for s in placed.addressable_shards:
                res[f"{arch}/final/{devs.index(s.device)}{k}"] = np.asarray(s.data)
    np.savez(out_path, **res)


def _port_rank(rank, inputs):
    from repro_torch.convert import convert_lm_params
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.dist import comm
    from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_local, tree_to_storage
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.models import moe
    from repro_torch.models.init import init_params
    from repro_torch.optim.sgd import SGDConfig, init_momentum
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train.step import make_train_step, step_wire_table

    gaps, route = [], moe._route

    def recorded(x, w, E, k):  # the least gap among the top k + 1 probabilities
        top = torch.sort(torch.softmax(x.float() @ w.float(), -1), -1, descending=True).values
        gaps.append(float((top[:, :k] - top[:, 1:k + 1]).min()))
        return route(x, w, E, k)

    moe._route = recorded
    out = {}
    mcfg = MeshCfg(tp=TP, dp=DP)
    mesh = make_mesh_from_cfg(mcfg)
    opt = SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4)
    for arch in ARCHS:
        _, tcfg = _cfgs(arch)
        params = convert_lm_params(tcfg, _params(inputs, arch), device="cpu", tp=TP)
        _, metas = init_params(tcfg, device="meta", tp=TP)
        spec = build_spec_tree(params, metas, mcfg)
        storage = tree_to_storage(params, spec, mcfg)
        st = tree_to_local(storage, spec, mcfg, rank)
        out.update({f"{arch}/start{k}": v.numpy().copy() for k, v in _paths(st).items()})
        mom = init_momentum(st)
        plan = PrecisionPlan.build(tcfg.num_groups + 1, round_to=2)
        step = make_train_step(tcfg, mcfg, mesh, spec, opt, {"tokens": (B, S), "labels": (B, S)},
                               plan=plan)
        gaps.clear()
        for i in range(STEPS):
            tokens, labels = synthetic_lm_batch(tcfg.vocab_size, B, S, i, device="cpu")
            first = len(comm.LOG)
            st, mom, met = step(st, mom, {"tokens": tokens, "labels": labels}, LR)
            out[f"{arch}/loss/{i}"] = met["loss"].numpy()
            out[f"{arch}/norms/{i}"] = met["group_norms_sq"].numpy()
            out[f"{arch}/wire/{i}"] = comm.wire_by_traffic(comm.LOG[first:])
        # one routing call a layer a step (no remat): the layers with a near-tie
        assert len(gaps) == STEPS * tcfg.num_layers, len(gaps)
        out[f"{arch}/ties"] = sorted({j % tcfg.num_layers for j, g in enumerate(gaps)
                                     if g < TIE_GAP})
        out[f"{arch}/table"] = step_wire_table(plan, tcfg, spec, mcfg, (B, S))
        out.update({f"{arch}/final{k}": v.numpy() for k, v in _paths(st).items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_ranks

    tmp = tmp_path_factory.mktemp("moe_mesh")
    inputs = _inputs()
    inp, out = str(tmp / "inputs.npz"), str(tmp / "ref.npz")
    np.savez(inp, **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={TP * DP}"
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
    return dict(np.load(out)), port


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_and_norms_match_reference(runs, arch):
    ref, port = runs
    for i in range(STEPS):
        for p in port:
            np.testing.assert_allclose(p[f"{arch}/loss/{i}"], ref[f"{arch}/loss/{i}"],
                                       rtol=LOSS_RTOL, err_msg=f"step {i}")
            np.testing.assert_allclose(p[f"{arch}/norms/{i}"], ref[f"{arch}/norms/{i}"],
                                       rtol=NORM_RTOL, err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_updated_shards_match_reference(runs, arch):
    """Every rank's shards after two steps, as updates from the start; the
    router of a layer with a routing near-tie within ``FLIP_REL`` (the
    module docstring), the near-ties taken from every rank's routing, as
    the gradient sync sums every rank's router gradient; at most one layer
    has one."""
    ref, port = runs
    tied = {f"['groups'][{layer}]['p0']['mix']['router']"
            for p in port for layer in p[f"{arch}/ties"]}
    assert len(tied) <= 1, tied
    for r, p in enumerate(port):
        keys = [k[len(f"{arch}/final"):] for k in p if k.startswith(f"{arch}/final")]
        assert keys and tied <= set(keys), tied
        for k in keys:
            start, got = p[f"{arch}/start{k}"], p[f"{arch}/final{k}"]
            want = ref[f"{arch}/final/{r}{k}"]
            np.testing.assert_allclose(got, want, rtol=0, atol=UPDATE_ATOL, err_msg=f"{r}{k}")
            du, dw = got - start, want - start
            rel = np.linalg.norm(du - dw) / max(np.linalg.norm(dw), 1e-30)
            assert rel <= (FLIP_REL if k in tied else UPDATE_REL), (r, k, rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_measured_wire_equals_step_wire_table(runs, arch):
    """Per priced class, every step on every rank, in both layouts (the
    ``ep`` layout's boundaries are ``train.step.mixer_boundaries``')."""
    _, port = runs
    ep = arch == "arctic-480b"
    for p in port:
        table = p[f"{arch}/table"]
        for i in range(STEPS):
            wire = p[f"{arch}/wire/{i}"]
            for k in PRICED:
                assert wire.get(k, 0) == table[k], (arch, i, k, wire, table)
            assert set(wire) - set(PRICED) == {"grad_sync", "metrics", "loss"} | (
                {"relayout"} if ep else set())


# (arch, seq_parallel) of the remat runs: the wire tables' recomputed
# boundaries of each layout
REMAT_CASES = tuple((a, sp) for a in ARCHS for sp in (False, True))


def _remat_rank(rank):
    """One remat step (port only, seeded weights) of each REMAT_CASES case:
    the measured wire and ``step_wire_table`` per priced class."""
    import dataclasses

    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.dist import comm
    from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_local, tree_to_storage
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.models.init import init_params
    from repro_torch.optim.sgd import SGDConfig, init_momentum
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train.step import make_train_step, step_wire_table

    mcfg = MeshCfg(tp=TP, dp=DP)
    mesh = make_mesh_from_cfg(mcfg)
    out = {}
    for arch, sp in REMAT_CASES:
        cfg = dataclasses.replace(_cfgs(arch)[1], remat=True)
        params, metas = init_params(cfg, 0, device="cpu", tp=TP)
        spec = build_spec_tree(params, metas, mcfg)
        st = tree_to_local(tree_to_storage(params, spec, mcfg), spec, mcfg, rank)
        plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2, seq_parallel=sp)
        step = make_train_step(cfg, mcfg, mesh, spec, SGDConfig(lr=LR),
                               {"tokens": (B, S), "labels": (B, S)}, plan=plan)
        tokens, labels = synthetic_lm_batch(cfg.vocab_size, B, S, 0, device="cpu")
        first = len(comm.LOG)
        step(st, init_momentum(st), {"tokens": tokens, "labels": labels}, LR)
        out[(arch, sp)] = (comm.wire_by_traffic(comm.LOG[first:]),
                           step_wire_table(plan, cfg, spec, mcfg, (B, S)))
    return out


def test_remat_wire_equals_step_wire_table():
    """Under ``remat`` (the full-width configs' default) the recomputed
    forward's boundaries (``remat_tp_collectives``) are in the table too:
    the ``tp`` and ``ep`` layouts, psum and sequence-parallel."""
    from repro_torch.launch.mesh import spawn_ranks

    for p in spawn_ranks(_remat_rank, TP * DP):
        for case, (wire, table) in p.items():
            for k in PRICED:
                assert wire.get(k, 0) == table[k], (case, k, wire, table)


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
