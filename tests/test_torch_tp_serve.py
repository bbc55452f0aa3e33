"""Serving at tp > 1 across gloo ranks: the port against the JAX reference.

The reference's outputs come from one subprocess of this file (``python
tests/test_torch_tp_serve.py INPUTS OUT``) run with 4 emulated host
devices, calling only the reference's public functions at
``MeshCfg(tp=2, dp=1)`` and ``MeshCfg(tp=2, dp=2)``: ``make_place_step``
(each device's placed block, read off the output's shards),
``make_prefill_step`` / ``make_decode_step`` (the gathered logits of a
2-row prefill and one decode step), ``global_cache_shapes`` and
``generate_static``, with plans at ``round_to=2``, with ``act_round_to=2``
and with ``seq_parallel``. The reference's engine fails at any mesh under
jax 0.9.0 (ROADMAP Queue 3), so the port's engines are held to the port's
static streams, which are held to the reference's. The port runs as 2 and
4 gloo ranks, processes spawned by ``repro_torch.launch.mesh.spawn_ranks``
(one CPU thread each), each mesh once for the module. Inputs are numpy from
seeds: reduced qwen3-1.7b (2 layers, d 256, 4 heads over 4 kv heads, hd
64, vocab 512; at tp 2 a rank holds 2 heads over 2 kv heads and half the
vocabulary) with the reference's ``init_params(cfg, PRNGKey(0), tp=2)``
weights, converted, and prompts of 16, 16 and 12 tokens from
``default_rng(0)``.

Tolerances. Placed weights, local cache shapes, token streams, wire
bytes per class and the host<->device bytes are equal, bit for bit and
byte for byte. Logits are within ``LOGIT_TOL`` of the reference's
(seen: 7.5e-7 at most, with logits O(0.5): fp32 sums in another order in
XLA and PyTorch), at ``act_round_to=2`` within ``ACT2_LOGIT_TOL`` (seen:
1.2e-3, see there), and bit-equal on every rank. Inside the port the
sequence-parallel prefill and a decode step under a sequence-parallel
env give the psum layout's bits.
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
TP = 2
MESHES = {"1x2": 1, "2x2": 2}  # name -> dp
LENS, GEN, SLOTS = (16, 16, 12), 4, 2
# (label, PrecisionPlan.build keywords at round_to 2)
PLANS = (("rt2", {}), ("act2", {"act_round_to": 2}), ("seq", {"seq_parallel": True}))
DECODE_TOKENS = ((5,), (7,))  # the decode step's feed after the 2-row prefill
LOGIT_TOL = dict(atol=2e-6, rtol=1e-5)
# act2: the TP-region sums rounded to bf16 (nearest). fp32 sums in another
# order in XLA and PyTorch put a few values on the other side of a rounding
# midpoint; each flip moves one activation by a bf16 step and the next
# boundaries' roundings carry it on, so the logits part by up to a bf16
# step (seen: 1.2e-3 at logits O(0.5)); the transport itself is bit-equal
# to the reference's (tests/test_torch_tp.py), and the streams are equal
ACT2_LOGIT_TOL = dict(atol=4e-3, rtol=0)


def _cfgs():
    from repro_torch.configs.registry import get_config, reduced

    return j_reduced(j_get_config("qwen3-1.7b")), reduced(get_config("qwen3-1.7b"))


def _paths(tree):
    """{path: leaf} of a reference or port tree (dicts and lists)."""
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _inputs() -> dict:
    jcfg, _ = _cfgs()
    params, _ = j_init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    out = {f"w{k}": np.asarray(v) for k, v in _paths(params).items()}
    rng = np.random.default_rng(0)
    for i, S in enumerate(LENS):
        out[f"prompt{i}"] = rng.integers(0, jcfg.vocab_size, S).astype(np.int32)
    return out


def _params(inputs):
    jcfg, _ = _cfgs()
    shapes = jax.eval_shape(lambda k: j_init_params(jcfg, k, tp=TP)[0], jax.random.PRNGKey(0))
    flat = [inputs[f"w{k}"] for k in _paths(shapes)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), flat)


def _cache_leaves(caches) -> dict:
    """{path: leaf} of a cache tree of either package (groups of
    ``{"p0": node}``, a node's ``k``, ``v`` and ``pos``)."""
    return {f"[{g}]['{key}'].{f}": getattr(node, f)
            for g, group in enumerate(caches) for key, node in group.items()
            for f in ("k", "v", "pos")}


def _prompts(inputs):
    return [tuple(int(t) for t in inputs[f"prompt{i}"]) for i in range(len(LENS))]


# ---------------------------------------------------------------------------
# the reference (a subprocess of this file, 4 emulated host devices)
# ---------------------------------------------------------------------------


def _device_blocks(arr, mesh):
    """{rank: numpy block} of a sharded array (rank = the device's place in
    the mesh, mesh order)."""
    devs = list(mesh.devices.flat)
    return {devs.index(s.device): np.asarray(s.data) for s in arr.addressable_shards}


def _reference(inputs_path, out_path):
    import jax.numpy as jnp

    from repro.dist.spec import MeshCfg as JMesh
    from repro.dist.spec import build_spec_tree, tree_to_storage
    from repro.launch.mesh import make_mesh_from_cfg
    from repro.plan import PrecisionPlan as JPlan
    from repro.serve.engine import Request, generate_static
    from repro.serve.step import (
        global_cache_shapes, make_decode_step, make_place_step, make_prefill_step,
    )

    inputs = dict(np.load(inputs_path))
    res = {}
    jcfg, _ = _cfgs()
    nrt = jcfg.num_groups + 1
    params = jax.tree_util.tree_map(jnp.asarray, _params(inputs))
    _, metas = j_init_params(jcfg, None, tp=TP)
    prompts = _prompts(inputs)
    requests = [Request(rid=i, prompt_ids=p, max_new=GEN) for i, p in enumerate(prompts)]
    B, S = 2, LENS[0]
    tokens = jnp.asarray(np.array(prompts[:2], np.int32))
    for name, dp in MESHES.items():
        mcfg = JMesh(tp=TP, dp=dp)
        mesh = make_mesh_from_cfg(mcfg)
        spec = build_spec_tree(params, metas, mcfg)
        storage = tree_to_storage(params, spec, mcfg)
        for paged in (False, True):
            shapes = global_cache_shapes(
                jcfg, mcfg, SLOTS, S + GEN, per_slot=True, shard_batch=not paged,
                paged_pages=6 if paged else None, page_size=8)
            for k, v in _cache_leaves(shapes).items():
                res[f"{name}/shapes/{paged}{k}"] = np.array(v.shape)
        with mesh:
            place, _ = make_place_step(jcfg, mcfg, mesh, spec,
                                       plan=JPlan.build(nrt, round_to=2))
            for k, v in _paths(place(storage)).items():
                for r, blk in _device_blocks(v, mesh).items():
                    res[f"{name}/placed/{r}{k}"] = blk
            for label, kw in PLANS:
                plan = JPlan.build(nrt, round_to=2, **kw)
                prefill = make_prefill_step(
                    jcfg, mcfg, mesh, spec, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)},
                    plan=plan, cache_capacity=S + GEN)
                logits, caches = prefill(storage, {"tokens": tokens})
                res[f"{name}/{label}/prefill"] = np.asarray(logits)
                if label != "seq":  # decode drops the layout: the rt2 step
                    decode = make_decode_step(
                        jcfg, mcfg, mesh, spec,
                        {"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32),
                         "pos": jax.ShapeDtypeStruct((), jnp.int32)}, plan=plan)
                    logits, _ = decode(storage, caches,
                                       {"tokens": jnp.asarray(DECODE_TOKENS, jnp.int32),
                                        "pos": jnp.asarray(S, jnp.int32)})
                    res[f"{name}/{label}/decode"] = np.asarray(logits)
                streams = generate_static(jcfg, mcfg, mesh, spec, storage, requests, plan=plan)
                for rid, ids in streams.items():
                    res[f"{name}/{label}/static/{rid}"] = np.array(ids)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------


def _port_rank(rank, name, inputs):
    """Everything the port computes on one rank of mesh ``name``, as plain
    data."""
    from repro_torch.convert import convert_lm_params
    from repro_torch.dist import comm
    from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_local, tree_to_storage
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.launch.serve import check_wire, wire_against_table
    from repro_torch.models import model as M
    from repro_torch.models.init import init_params
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.engine import Request, ServeEngine, generate_static
    from repro_torch.serve.step import (
        global_cache_shapes, make_decode_step, make_place_step, make_prefill_step,
        serve_wire_table,
    )
    from repro_torch.train.step import make_mat_fns

    out = {}
    _, tcfg = _cfgs()
    nrt = tcfg.num_groups + 1
    mcfg = MeshCfg(tp=TP, dp=MESHES[name])
    mesh = make_mesh_from_cfg(mcfg)
    params = convert_lm_params(tcfg, _params(inputs), device="cpu", tp=TP)
    _, metas = init_params(tcfg, device="meta", tp=TP)
    spec = build_spec_tree(params, metas, mcfg)
    storage = tree_to_local(tree_to_storage(params, spec, mcfg), spec, mcfg, rank)
    del params
    prompts = _prompts(inputs)
    requests = [Request(rid=i, prompt_ids=p, max_new=GEN) for i, p in enumerate(prompts)]
    B, S = 2, LENS[0]
    tokens = torch.tensor(prompts[:2], dtype=torch.int32)
    feed = torch.tensor(DECODE_TOKENS, dtype=torch.int32)
    for paged in (False, True):
        shapes = global_cache_shapes(tcfg, mcfg, SLOTS, S + GEN, per_slot=True,
                                     shard_batch=not paged, paged_pages=6 if paged else None,
                                     page_size=8)
        for k, v in _cache_leaves(shapes).items():
            out[f"shapes/{paged}{k}"] = tuple(v.shape)
    placed = make_place_step(tcfg, mcfg, mesh, spec, plan=PrecisionPlan.build(nrt, round_to=2))
    first = len(comm.LOG)
    for k, v in _paths(placed(storage)).items():
        out[f"placed{k}"] = v.numpy()
    out["place_wire"] = comm.wire_by_traffic(comm.LOG[first:])
    out["place_table"] = serve_wire_table(PrecisionPlan.build(nrt, round_to=2), tcfg, spec,
                                          mcfg, rows=1, tokens=1)

    for label, kw in PLANS:
        plan = PrecisionPlan.build(nrt, round_to=2, **kw)
        seq = label == "seq"
        prefill = make_prefill_step(tcfg, mcfg, mesh, spec, plan=plan, cache_capacity=S + GEN)
        first = len(comm.LOG)
        logits, caches = prefill(storage, {"tokens": tokens})
        out[f"{label}/prefill"] = logits.numpy()
        rows = B // mcfg.dshards
        out[f"{label}/prefill/wire"] = (
            comm.wire_by_traffic(comm.LOG[first:]),
            serve_wire_table(plan, tcfg, spec, mcfg, rows=rows, tokens=S, seq_parallel=seq))
        decode = make_decode_step(tcfg, mcfg, mesh, spec, plan=plan)
        first = len(comm.LOG)
        logits, _ = decode(storage, caches, {"tokens": feed, "pos": torch.tensor(S)})
        out[f"{label}/decode"] = logits.numpy()
        out[f"{label}/decode/wire"] = (comm.wire_by_traffic(comm.LOG[first:]),
                                       serve_wire_table(plan, tcfg, spec, mcfg, rows=rows,
                                                        tokens=1))
        static = generate_static(tcfg, mcfg, mesh, spec, storage, requests, plan=plan)
        out[f"{label}/static"] = static
        for kind in ("engine", "stationary", "paged"):
            eng = ServeEngine(tcfg, mcfg, mesh, spec, storage, plan=plan, max_slots=SLOTS,
                              cache_capacity=S + GEN, weight_stationary=kind == "stationary",
                              paged=kind == "paged", page_size=8)
            res = eng.run(requests)
            check_wire(eng, plan, requests)
            out[f"{label}/{kind}"] = {rid: r.tokens for rid, r in res.items()}
            out[f"{label}/{kind}/wire"] = wire_against_table(eng)
            out[f"{label}/{kind}/kinds"] = sorted({k for r in eng.wire_log for k in r["wire"]})

    # a decode step under the sequence-parallel env against the psum layout's,
    # from the same caches, through the model's forward itself
    plan = PrecisionPlan.build(nrt, round_to=2)
    prefill = make_prefill_step(tcfg, mcfg, mesh, spec, plan=plan, cache_capacity=S + GEN,
                                shard_batch=False)
    _, caches = prefill(storage, {"tokens": tokens})
    mat_group, mat_top = make_mat_fns(spec, mcfg, plan.weight_policies(), group=mesh.fsdp)
    for label, seq in (("psum", False), ("seq", True)):
        env = PrecisionPlan.build(nrt, round_to=2, seq_parallel=seq).make_env(mcfg, mesh)
        c = [{k: type(n)(*(x.clone() for x in (n.k, n.v, n.pos))) for k, n in g.items()}
             for g in caches]
        logits, c = M.forward_decode(storage, {"tokens": feed, "pos": torch.tensor(S)}, c,
                                     tcfg, env, mat_group=mat_group, mat_top=mat_top(storage))
        out[f"forward_decode/{label}"] = (logits.numpy(), [x.numpy() for x in
                                                           _cache_leaves(c).values()])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, {mesh: [per-rank port outputs]}): the reference
    subprocess runs while the port's ranks do."""
    from repro_torch.launch.mesh import spawn_ranks

    tmp = tmp_path_factory.mktemp("tp_serve")
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
        port = {name: spawn_ranks(_port_rank, TP * dp, name, inputs)
                for name, dp in MESHES.items()}
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference failed:\n{stdout[-3000:]}\n{stderr[-3000:]}"
    return dict(np.load(out)), port


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("name", list(MESHES))
def test_placed_leaves_bit_equal_reference(runs, name):
    """``make_place_step`` on a sharded mesh (the FSDP gather at 2×2, the
    quantize at 1×2): every rank's resident TP-local weights are the
    reference's block for its device, bit for bit; the placement's
    ``weights`` bytes are one forward's gathers."""
    ref, port = runs
    for r, p in enumerate(port[name]):
        keys = [k for k in p if k.startswith("placed")]
        assert len(keys) == 25  # 11 a layer group, embed, head, final norm
        for k in keys:
            np.testing.assert_array_equal(_bits(p[k]), _bits(ref[f"{name}/placed/{r}{k[6:]}"]),
                                          f"rank {r} {k}")
        assert p["place_wire"].get("weights", 0) == p["place_table"]["weights"]
        assert bool(p["place_wire"]) == (name == "2x2")


@pytest.mark.parametrize("name", list(MESHES))
def test_local_cache_shapes_are_the_reference_global_ones_divided(runs, name):
    """``global_cache_shapes`` gives one rank's caches: the reference's
    global shapes with the kv heads divided by tp and, for the contiguous
    slotted layout, the batch by dp (a page pool keeps every slot)."""
    ref, port = runs
    dp = MESHES[name]
    for paged in (False, True):
        keys = [k for k in port[name][0] if k.startswith(f"shapes/{paged}")]
        assert len(keys) == 6  # k, v, pos of 2 layers
        for k in keys:
            want = list(ref[f"{name}/shapes/{paged}{k[len(f'shapes/{paged}'):]}"])
            if len(want) == 5:  # (R, B | P, C | page, Kv, hd)
                want[3] //= TP
                want[1] //= 1 if paged else dp
            elif not paged:  # a per-slot pos (R, B)
                want[1] //= dp
            for p in port[name]:
                assert p[k] == tuple(want), (k, p[k], want)


@pytest.mark.parametrize("label", [p[0] for p in PLANS])
@pytest.mark.parametrize("name", list(MESHES))
def test_step_logits_match_reference(runs, name, label):
    """A 2-row prefill (rows sharded at 2×2) and one decode step: the
    gathered ``(B, 1, V)`` logits within ``LOGIT_TOL`` of the reference's,
    and bit-equal on every rank."""
    ref, port = runs
    for kind in ("prefill", "decode"):
        want = ref[f"{name}/{'rt2' if (label, kind) == ('seq', 'decode') else label}/{kind}"]
        for p in port[name]:
            got = p[f"{label}/{kind}"]
            assert got.shape == want.shape == (2, 1, 512)
            np.testing.assert_allclose(got, want, **(ACT2_LOGIT_TOL if label == "act2"
                                                     else LOGIT_TOL))
            np.testing.assert_array_equal(_bits(got), _bits(port[name][0][f"{label}/{kind}"]))


@pytest.mark.parametrize("label", [p[0] for p in PLANS])
@pytest.mark.parametrize("name", list(MESHES))
def test_static_streams_equal_reference(runs, name, label):
    """``generate_static`` at the mesh: the reference's greedy streams, token
    for token, on every rank."""
    ref, port = runs
    for p in port[name]:
        got = p[f"{label}/static"]
        assert sorted(got) == [0, 1, 2]
        for rid, ids in got.items():
            assert ids == ref[f"{name}/{label}/static/{rid}"].tolist(), (rid, label)


@pytest.mark.parametrize("label", [p[0] for p in PLANS])
@pytest.mark.parametrize("name", list(MESHES))
def test_engines_equal_port_static(runs, name, label):
    """The contiguous, weight-stationary and paged engines at the mesh give
    the port's static streams exactly (engine == static, the reference's
    pin), with the measured wire per class equal to ``serve_wire_table``
    of each forward and the host<->device bytes equal to
    ``serve_host_device_bytes`` (checked in the ranks)."""
    _, port = runs
    for p in port[name]:
        for kind in ("engine", "stationary", "paged"):
            assert p[f"{label}/{kind}"] == p[f"{label}/static"], kind
            got, want = p[f"{label}/{kind}/wire"]
            assert got == want, (kind, got, want)
            assert got["activations"] + got["seq_boundary"] > 0
            moved = set(p[f"{label}/{kind}/kinds"])
            assert "logits" in moved and ("weights" in moved) == (name == "2x2")


@pytest.mark.parametrize("label", [p[0] for p in PLANS])
@pytest.mark.parametrize("name", list(MESHES))
def test_step_wire_equals_serve_wire_table(runs, name, label):
    """Each step's collectives per class equal ``serve_wire_table``: one
    forward's TP-region exits (2 a layer + the embedding's), packed at
    ``act_round_to`` 2, a scatter/gather pair under ``seq_parallel`` for
    the prefill, and the weight gathers at 2×2; the logits gather is
    unpriced."""
    _, port = runs
    for p in port[name]:
        for kind in ("prefill", "decode"):
            got, table = p[f"{label}/{kind}/wire"]
            for k in ("weights", "gradients", "activations", "seq_boundary"):
                assert got.get(k, 0) == table[k], (kind, k, got, table)
            assert got["logits"] > 0
            assert bool(got.get("seq_boundary")) == (label == "seq" and kind == "prefill")


@pytest.mark.parametrize("name", list(MESHES))
def test_decode_under_seq_parallel_env_is_the_psum_step(runs, name):
    """``forward_decode`` with a sequence-parallel env at tp 2 drops the
    layout, as the reference does: logits and updated caches bit-equal to
    the psum layout's step from the same caches."""
    _, port = runs
    for p in port[name]:
        (lp, cp), (ls, cs) = p["forward_decode/psum"], p["forward_decode/seq"]
        np.testing.assert_array_equal(_bits(ls), _bits(lp))
        assert len(cs) == len(cp) == 6
        for a, b in zip(cs, cp):
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
