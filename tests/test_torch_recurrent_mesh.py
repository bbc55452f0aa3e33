"""The recurrent families across gloo ranks: the port against the JAX
reference at tp 2, at ``reduced()`` (xlstm-1.3b: ``(mlstm, slstm)`` × 2;
recurrentgemma-9b: ``(rglru, local)`` × 2, one kv head).

The reference runs in one subprocess of this file (``python
tests/test_torch_recurrent_mesh.py INPUTS OUT``) with 4 emulated host
devices: ``make_train_step`` at ``MeshCfg(tp=2, dp=2)`` (the jitted
function without its donation), two steps at ``round_to`` 2 from its
``init_params(cfg, PRNGKey(0), tp=2)`` weights on ``synthetic_lm_batch``
at B 8, S 16; and its greedy ``generate_static`` at ``MeshCfg(tp=2)``
(its engine fails at any mesh under jax 0.9.0, ROADMAP Queue 3). The port
runs 4 gloo ranks for the 2×2 training and 2 for the 1×2 serving
(``spawn_ranks``, one CPU thread each).

Training (2×2): losses within rtol 1e-5, Σw² within rtol 1e-5, every
rank's updated shards within atol 1e-6 and a relative l2 of the update of
1e-3 (``tests/test_torch_moe_mesh.py``'s bars); the measured wire per
priced class equal to ``step_wire_table`` at every step — the mLSTM's and
RG-LRU's enter / exit pairs, the SwiGLU's, the sLSTM's none. The port
alone, with ``remat`` on, psum and sequence-parallel layouts: the measured
wire equals the table's recomputed boundaries.

Serving (1×2): the port's engine, with and without ``seq_parallel``, and
its static run equal the reference's greedy ``generate_static`` at tp
2 and the port's one-device streams; each forward's wire equals
``serve_wire_table``; the mLSTM's state on a rank holds every head and
half of each head's value columns, the sLSTM's state is the same on both
ranks, recurrentgemma's one kv head is whole on each rank.

Last, a CPU rehearsal of ``chip_smoke.py`` phase 21 at reduced widths.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TP, DP = 2, 2
B, S, LR, STEPS = 8, 16, 0.05, 2
ARCHS = ("xlstm-1.3b", "recurrentgemma-9b")
LOSS_RTOL = NORM_RTOL = 1e-5
UPDATE_ATOL, UPDATE_REL = 1e-6, 1e-3
PRICED = ("weights", "gradients", "activations", "seq_boundary")
LENS, GEN = (16, 8, 16), 4


# The ranks import this file and run the port alone: JAX and the reference
# are imported inside the functions that use them, and the ranks receive
# the reference's weights already converted, as numpy trees.


def _cfgs(arch):
    from repro.configs.registry import get_config as j_get_config
    from repro.configs.registry import reduced as j_reduced

    return j_reduced(j_get_config(arch)), _tcfg(arch)


def _tcfg(arch):
    from repro_torch.configs.registry import get_config, reduced

    return reduced(get_config(arch))


def _paths(tree):
    import jax

    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _port_paths(tree, prefix=""):
    """A port tree's leaves (nested dicts and lists) by the path
    ``jax.tree_util.keystr`` gives the same leaf in the reference's tree."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in
                _port_paths(tree[key], f"{prefix}[{key!r}]").items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in
                _port_paths(x, f"{prefix}[{i}]").items()}
    return {} if tree is None else {prefix: tree}


def _inputs() -> dict:
    import jax

    from repro.models.init import init_params as j_init_params

    out = {}
    for arch in ARCHS:
        jcfg, _ = _cfgs(arch)
        for tp in (1, TP):
            params, _ = j_init_params(jcfg, jax.random.PRNGKey(0), tp=tp)
            out.update({f"{arch}/tp{tp}/w{k}": np.asarray(v) for k, v in _paths(params).items()})
    return out


def _params(inputs, arch, tp=TP):
    import jax

    from repro.models.init import init_params as j_init_params

    jcfg, _ = _cfgs(arch)
    shapes = jax.eval_shape(lambda k: j_init_params(jcfg, k, tp=tp)[0], jax.random.PRNGKey(0))
    flat = [inputs[f"{arch}/tp{tp}/w{k}"] for k in _paths(shapes)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), flat)


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [tuple(int(t) for t in rng.integers(0, vocab, n)) for n in LENS]


def _converted(inputs, tp=TP):
    """The reference's weights in the port's layout at ``tp``, as numpy."""
    from repro_torch.convert import convert_lm_params
    from repro_torch.utils.trees import tree_map

    return {arch: tree_map(lambda t: t.numpy(), convert_lm_params(
        _tcfg(arch), _params(inputs, arch, tp=tp), device="cpu", tp=tp)) for arch in ARCHS}


def _reference(inputs_path, out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.data.pipeline import synthetic_lm_batch as j_batch
    from repro.dist.spec import MeshCfg as JMesh
    from repro.dist.spec import build_spec_tree, leaf_partition_spec, tree_to_storage
    from repro.launch.mesh import make_mesh_from_cfg
    from repro.models.init import init_params as j_init_params
    from repro.optim.sgd import SGDConfig, init_momentum
    from repro.plan import PrecisionPlan as JPlan
    from repro.serve import engine as jeng
    from repro.train.step import make_train_step

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
        # greedy generate_static at tp 2 (the model axis of a 1×2 mesh)
        scfg = JMesh(tp=TP)
        smesh = make_mesh_from_cfg(scfg)
        sspec = build_spec_tree(params, metas, scfg)
        reqs = [jeng.Request(rid=i, prompt_ids=p, max_new=GEN)
                for i, p in enumerate(_prompts(jcfg.vocab_size))]
        with smesh:
            streams = jeng.generate_static(jcfg, scfg, smesh, sspec,
                                           tree_to_storage(params, sspec, scfg), reqs, plan=plan)
        for rid, toks in streams.items():
            res[f"{arch}/stream/{rid}"] = np.asarray(toks)
    np.savez(out_path, **res)


def _train_rank(rank, weights):
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.dist import comm
    from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_local, tree_to_storage
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.models.init import init_params
    from repro_torch.optim.sgd import SGDConfig, init_momentum
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train.step import make_train_step, step_wire_table
    from repro_torch.utils.trees import tree_map

    out = {}
    mcfg = MeshCfg(tp=TP, dp=DP)
    mesh = make_mesh_from_cfg(mcfg)
    opt = SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4)
    for arch in ARCHS:
        tcfg = _tcfg(arch)
        params = tree_map(torch.from_numpy, weights[arch])
        _, metas = init_params(tcfg, device="meta", tp=TP)
        spec = build_spec_tree(params, metas, mcfg)
        st = tree_to_local(tree_to_storage(params, spec, mcfg), spec, mcfg, rank)
        out.update({f"{arch}/start{k}": v.numpy().copy() for k, v in _port_paths(st).items()})
        mom = init_momentum(st)
        plan = PrecisionPlan.build(tcfg.num_groups + 1, round_to=2)
        step = make_train_step(tcfg, mcfg, mesh, spec, opt, {"tokens": (B, S), "labels": (B, S)},
                               plan=plan)
        for i in range(STEPS):
            tokens, labels = synthetic_lm_batch(tcfg.vocab_size, B, S, i, device="cpu")
            first = len(comm.LOG)
            st, mom, met = step(st, mom, {"tokens": tokens, "labels": labels}, LR)
            out[f"{arch}/loss/{i}"] = met["loss"].numpy()
            out[f"{arch}/norms/{i}"] = met["group_norms_sq"].numpy()
            out[f"{arch}/wire/{i}"] = comm.wire_by_traffic(comm.LOG[first:])
        out[f"{arch}/table"] = step_wire_table(plan, tcfg, spec, mcfg, (B, S))
        out.update({f"{arch}/final{k}": v.numpy() for k, v in _port_paths(st).items()})
    # remat (the full-width configs' default), psum and sequence-parallel: port only
    for arch in ARCHS:
        cfg = dataclasses.replace(_tcfg(arch), remat=True)
        params, metas = init_params(cfg, 0, device="cpu", tp=TP)
        spec = build_spec_tree(params, metas, mcfg)
        st = tree_to_local(tree_to_storage(params, spec, mcfg), spec, mcfg, rank)
        for sp in (False, True):
            plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2, seq_parallel=sp)
            step = make_train_step(cfg, mcfg, mesh, spec, SGDConfig(lr=LR),
                                   {"tokens": (B, S), "labels": (B, S)}, plan=plan)
            tokens, labels = synthetic_lm_batch(cfg.vocab_size, B, S, 0, device="cpu")
            first = len(comm.LOG)
            step(st, init_momentum(st), {"tokens": tokens, "labels": labels}, LR)
            out[f"{arch}/remat/{sp}"] = (comm.wire_by_traffic(comm.LOG[first:]),
                                         step_wire_table(plan, cfg, spec, mcfg, (B, S)))
    return out


def _serve_rank(rank, weights):
    """The 1×2 engine and static runs of each arch (psum; seq-parallel
    prefills), their streams, wire per forward against
    ``serve_wire_table`` and the states' shapes and values."""
    from repro_torch.dist import comm
    from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_local, tree_to_storage
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.models import ssm
    from repro_torch.models.init import init_params
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.api import Request
    from repro_torch.serve.engine import ServeEngine, generate_static
    from repro_torch.train.step import COLLECTIVE_CLASSES
    from repro_torch.utils.trees import tree_map

    mcfg = MeshCfg(tp=TP)
    mesh = make_mesh_from_cfg(mcfg)
    out = {}
    for arch in ARCHS:
        tcfg = _tcfg(arch)
        params = tree_map(torch.from_numpy, weights[arch])
        _, metas = init_params(tcfg, device="meta", tp=TP)
        spec = build_spec_tree(params, metas, mcfg)
        st = tree_to_local(tree_to_storage(params, spec, mcfg), spec, mcfg, rank)
        reqs = [Request(rid=i, prompt_ids=p, max_new=GEN)
                for i, p in enumerate(_prompts(tcfg.vocab_size))]
        for sp in (False, True):
            plan = PrecisionPlan.build(tcfg.num_groups + 1, round_to=2, seq_parallel=sp)
            if not sp:  # the static run once; the engine's prefills take both layouts
                out[f"{arch}/static"] = generate_static(tcfg, mcfg, mesh, spec, st, reqs,
                                                        plan=plan)
            eng = ServeEngine(tcfg, mcfg, mesh, spec, st, plan=plan, max_slots=2,
                              cache_capacity=max(LENS) + GEN)
            out[f"{arch}/engine/{sp}"] = {k: r.tokens for k, r in eng.run(reqs).items()}
            out[f"{arch}/wire_ok/{sp}"] = all(
                r["wire"].get(k, 0) == t[k] for r, t in zip(eng.wire_log, eng.wire_tables(),
                                                             strict=True)
                for k in COLLECTIVE_CLASSES)
            out[f"{arch}/seq_wire/{sp}"] = sum(r["wire"].get("seq_boundary", 0)
                                               for r in eng.wire_log)
            states = {}
            for key, node in eng._caches[0].items():
                if isinstance(node, (ssm.MLSTMState, ssm.SLSTMState)):
                    states[type(node).__name__] = [x.clone().numpy() for x in
                                                   ssm.state_leaves(node)]
                elif hasattr(node, "k"):
                    states["kv_heads"] = node.k.shape[-2]
            out[f"{arch}/states/{sp}"] = states
        del comm.LOG[:]
    return out


def _one_device_streams(inputs, arch):
    """The port's one-device greedy static streams from the tp-1 weights."""
    from repro_torch.convert import convert_lm_params
    from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_storage
    from repro_torch.models.init import init_params
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.api import Request
    from repro_torch.serve.engine import generate_static

    _, tcfg = _cfgs(arch)
    params = convert_lm_params(tcfg, _params(inputs, arch, tp=1), device="cpu")
    _, metas = init_params(tcfg, device="meta")
    spec = build_spec_tree(params, metas, MeshCfg())
    reqs = [Request(rid=i, prompt_ids=p, max_new=GEN)
            for i, p in enumerate(_prompts(tcfg.vocab_size))]
    return generate_static(tcfg, MeshCfg(), None, spec, tree_to_storage(params, spec, MeshCfg()),
                           reqs, plan=PrecisionPlan.build(tcfg.num_groups + 1, round_to=2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_ranks

    tmp = tmp_path_factory.mktemp("recurrent_mesh")
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
        weights = _converted(inputs)
        train = spawn_ranks(_train_rank, TP * DP, weights)
        serve = spawn_ranks(_serve_rank, TP, weights)
        one = {arch: _one_device_streams(inputs, arch) for arch in ARCHS}
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference failed:\n{stdout[-3000:]}\n{stderr[-3000:]}"
    return dict(np.load(out)), train, serve, one


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_and_norms_match_reference(runs, arch):
    ref, port, _, _ = runs
    for i in range(STEPS):
        for p in port:
            np.testing.assert_allclose(p[f"{arch}/loss/{i}"], ref[f"{arch}/loss/{i}"],
                                       rtol=LOSS_RTOL, err_msg=f"step {i}")
            np.testing.assert_allclose(p[f"{arch}/norms/{i}"], ref[f"{arch}/norms/{i}"],
                                       rtol=NORM_RTOL, err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_updated_shards_match_reference(runs, arch):
    """Every rank's shards after two steps, as updates from the start."""
    ref, port, _, _ = runs
    for r, p in enumerate(port):
        keys = [k[len(f"{arch}/final"):] for k in p if k.startswith(f"{arch}/final")]
        assert keys
        for k in keys:
            start, got = p[f"{arch}/start{k}"], p[f"{arch}/final{k}"]
            want = ref[f"{arch}/final/{r}{k}"]
            np.testing.assert_allclose(got, want, rtol=0, atol=UPDATE_ATOL, err_msg=f"{r}{k}")
            du, dw = got - start, want - start
            rel = np.linalg.norm(du - dw) / max(np.linalg.norm(dw), 1e-30)
            assert rel <= UPDATE_REL, (r, k, rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_measured_wire_equals_step_wire_table(runs, arch):
    """Per priced class, every step on every rank; then the remat runs in
    both layouts."""
    _, port, _, _ = runs
    for p in port:
        table = p[f"{arch}/table"]
        for i in range(STEPS):
            wire = p[f"{arch}/wire/{i}"]
            for k in PRICED:
                assert wire.get(k, 0) == table[k], (arch, i, k, wire, table)
        for sp in (False, True):
            wire, table = p[f"{arch}/remat/{sp}"]
            for k in PRICED:
                assert wire.get(k, 0) == table[k], (arch, sp, k, wire, table)
            assert (wire.get("seq_boundary", 0) > 0) == sp


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_streams_match_reference_and_one_device(runs, arch):
    """The 1×2 engine and static runs (psum and seq-parallel prefills)
    equal the reference's greedy ``generate_static`` at tp 2 and the
    port's one device; both ranks alike; each forward's wire equals
    ``serve_wire_table``."""
    ref, _, serve, one = runs
    want = {rid: ref[f"{arch}/stream/{rid}"].tolist() for rid in range(len(LENS))}
    assert one[arch] == want
    for p in serve:
        assert p[f"{arch}/static"] == want
        for sp in (False, True):
            assert p[f"{arch}/engine/{sp}"] == want
            assert p[f"{arch}/wire_ok/{sp}"]
            assert (p[f"{arch}/seq_wire/{sp}"] > 0) == sp


def test_tp2_states_shard_as_the_reference_specs(runs):
    """The mLSTM's ``C`` on a rank: every head, half of each head's value
    columns (the reference's ``cache_pspecs`` shards its last dim); the
    sLSTM's state identical on both ranks (replicated); recurrentgemma's
    one kv head whole on each rank."""
    _, _, serve, _ = runs
    tcfg = _tcfg("xlstm-1.3b")
    dv = int(tcfg.mlstm_proj_factor * tcfg.d_model)
    H = tcfg.num_heads
    for sp in (False, True):
        C = [p[f"xlstm-1.3b/states/{sp}"]["MLSTMState"][0] for p in serve]
        assert all(c.shape == (1, 2, H, dv // H, dv // H // TP) for c in C)
        assert not np.array_equal(C[0], C[1])
        sl = [p[f"xlstm-1.3b/states/{sp}"]["SLSTMState"] for p in serve]
        assert all(np.array_equal(a, b) for a, b in zip(*sl))
        assert all(p[f"recurrentgemma-9b/states/{sp}"]["kv_heads"] == 1 for p in serve)


def test_chip_smoke_recurrent_phase_rehearses_on_cpu():
    """``chip_smoke.py`` phase 21 at reduced configs on the CPU (the plain
    versions; launch counts and memory are read on a card only): every
    stream, chunkwise, training and 1×2 check passes."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    from repro_torch.configs.registry import get_config, reduced

    def r(name):
        return reduced(get_config(name))

    out = chip_smoke.recurrent_path(
        torch, torch.device("cpu"), a_cfg=r("xlstm-1.3b"),
        b_cfg=dataclasses.replace(r("xlstm-1.3b"), remat=True), c_cfg=r("recurrentgemma-9b"),
        d_cfg=r("xlstm-1.3b"), lens=(16, 8, 12), gen=3, chunk=8, steps=2, seq=16)
    assert out["a"]["chunk"]["gap"] <= chip_smoke.REC_CHUNK_RTOL * out["a"]["chunk"]["scale"]
    assert len(out["b"]["losses"]) == 2 and all(np.isfinite(out["b"]["losses"]))
    assert set(out["c"]["runs"]) == {"engine"}
    assert all(v == 0 for v in out["launches"].values())  # no kernel on the CPU


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
