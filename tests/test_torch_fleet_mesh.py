"""The serving fleet at tp 2 across gloo ranks: the port against its
one-device fleet and the JAX reference.

Reduced qwen3-1.7b (2 layers, d 256, 4 heads over 4 kv heads, hd 64,
vocab 512: 2 kv heads a rank at tp 2) with ``tests/test_torch_fleet.py``'s
plan (``round_to=2`` weights and host_device entry), ``compress_min_size``
4096, pages of 8 tokens, 2 slots a replica, capacity 28, and the matrix of
``tests/scenarios/scenario_fleet.py``: FIFO, a reversed arrival order, a
replica joining and one leaving, int8 KV, a mid-run weight refresh, and
sampled requests. The weights are the reference's ``init_params(cfg,
PRNGKey(v), tp=2)`` for v 0 and 1 (at these widths tp pads nothing, so the
same trees serve one device), carried across by ``convert_lm_params``.

The port runs the matrix at 1×2 as 2 gloo ranks (``spawn_ranks``, one CPU
thread each) and at one device in this process. ``tests/test_torch_fleet.py``
holds the one-device fleet to the reference's router; the reference's own
fleet fails at any mesh (its engine raises ``ShardingTypeError``, ROADMAP
Reference caveats), so the tp-2 fleet is held to the one-device fleet, and
its greedy streams to the reference's ``generate_static`` at 1×2. That,
the reference publisher's parcels at 1×2 and its prefill worker at 1×2
come from one subprocess of this file (``python
tests/test_torch_fleet_mesh.py INPUTS OUT``) with 2 emulated host devices.

Tolerances. Streams, hop logs, byte counts, parcels and pools are exactly
equal; restored weight blocks bit-equal. KV page values of the tp-2 worker
are within ``KV_TOL`` of the one-device worker's and the reference
worker's: ``tests/test_torch_tp_serve.py``'s ``LOGIT_TOL``, the bar of its
tp-2 prefill outputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
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
MIN_SIZE = 4096
PAGE = 8
SLOTS = 2
CAP = 28  # scenario_fleet.py's capacity
GEN = 5
TAILS = (9, 4, 12, 7, 10)  # scenario_fleet.py's tails after a one-page shared prefix
SAMPLING = dict(temperature=0.8, top_p=0.95, top_k=40)
CASES = ("fifo", "reversed", "join_leave", "int8", "refresh", "sampled")
# tests/test_torch_tp_serve.py's LOGIT_TOL: its bar for tp-2 prefill outputs
KV_TOL = dict(atol=2e-6, rtol=1e-5)


def _paths(tree):
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _inputs() -> dict:
    jcfg = j_reduced(j_get_config("qwen3-1.7b"))
    out = {}
    for v in (0, 1):
        params, _ = j_init_params(jcfg, jax.random.PRNGKey(v), tp=TP)
        out.update({f"v{v}{k}": np.asarray(x) for k, x in _paths(params).items()})
    return out


def _params(inputs, v):
    """Version ``v``'s reference-layout numpy tree from the inputs."""
    jcfg = j_reduced(j_get_config("qwen3-1.7b"))
    shapes = jax.eval_shape(lambda k: j_init_params(jcfg, k, tp=TP)[0], jax.random.PRNGKey(0))
    flat = [inputs[f"v{v}{k}"] for k in _paths(shapes)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), flat)


def _requests(vocab, cls, *, rid_base=0, seed=3, sampled=False, sampling_cls=None):
    """scenario_fleet.py's requests: a one-page shared prefix, then tails."""
    rng = np.random.default_rng(seed)
    shared = tuple(int(t) for t in rng.integers(0, vocab, PAGE))
    out = []
    for i, tail in enumerate(TAILS):
        kw = {"sampling": sampling_cls(**SAMPLING, seed=100 + i)} if sampled else {}
        out.append(cls(rid=rid_base + i, max_new=GEN, **kw,
                       prompt_ids=shared + tuple(int(t) for t in rng.integers(0, vocab, tail))))
    return out


def _digest(parcel) -> list:
    """A weight parcel's entries, each wire and residual tier as a hash."""
    def h(b):
        return None if b is None else hashlib.sha256(b).hexdigest()

    return [(h(wire), h(res), info) for wire, res, info in parcel.entries]


# ---------------------------------------------------------------------------
# the reference (a subprocess of this file, 2 emulated host devices)
# ---------------------------------------------------------------------------


def _reference(inputs_path, out_path):
    import pickle

    import jax.numpy as jnp

    from repro.dist.spec import MeshCfg as JMesh
    from repro.dist.spec import build_spec_tree, tree_to_storage
    from repro.fleet import PrefillWorker, WeightPublisher
    from repro.launch.mesh import make_mesh_from_cfg
    from repro.plan import PrecisionPlan as JPlan
    from repro.serve.engine import Request, generate_static
    from repro.transport import CompressionPolicy as JPolicy

    inputs = dict(np.load(inputs_path))
    jcfg = j_reduced(j_get_config("qwen3-1.7b"))
    nrt = jcfg.num_groups + 1
    mcfg = JMesh(tp=TP, dp=1, compress_min_size=MIN_SIZE)
    mesh = make_mesh_from_cfg(mcfg)
    _, metas = j_init_params(jcfg, None, tp=TP)
    plan = JPlan(weights=(JPolicy(round_to=2),) * nrt, host_device=JPolicy(round_to=2))
    plan8 = dataclasses.replace(plan, int8_kv=True)
    storages, spec = [], None
    for v in (0, 1):
        params = jax.tree_util.tree_map(jnp.asarray, _params(inputs, v))
        spec = build_spec_tree(params, metas, mcfg)
        storages.append(tree_to_storage(params, spec, mcfg))
    reqs = _requests(jcfg.vocab_size, Request)
    wave_b = _requests(jcfg.vocab_size, Request, rid_base=len(reqs), seed=11)
    res = {"static": {}, "parcels": [], "worker": None}
    with mesh:
        for label, p, store, rs in (("fp32", plan, storages[0], reqs),
                                    ("int8", plan8, storages[0], reqs),
                                    ("v1", plan, storages[1], wave_b)):
            streams = generate_static(jcfg, mcfg, mesh, spec, store, rs, plan=p)
            res["static"][label] = {rid: list(map(int, t)) for rid, t in streams.items()}
        pub = WeightPublisher(jcfg, spec, plan=plan)
        res["parcels"] = [_digest(pub.publish(storages[0])),
                          _digest(pub.publish(storages[1], step=1))]
        try:  # the reference's worker at 1x2 (its engine fails at any mesh)
            worker = PrefillWorker("w0", jcfg, mcfg, mesh, spec, plan=plan, cache_capacity=CAP,
                                   page_size=PAGE)
            res["worker"] = {}
            for r in reqs:
                pages, first = worker.prefill(storages[0], r)
                res["worker"][r.rid] = ([{k: {a: np.asarray(x) for a, x in node.items()}
                                          for k, node in g.items()} for g in pages], first)
        except Exception as e:  # noqa: BLE001 — recorded and reported by the test
            res["worker"] = f"{type(e).__name__}: {e}"
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the port's fleet, on one device or on a rank of the mesh
# ---------------------------------------------------------------------------


def _plans(cfg):
    from repro_torch.plan import PrecisionPlan
    from repro_torch.transport import CompressionPolicy

    nrt = cfg.num_groups + 1
    plan = PrecisionPlan(weights=(CompressionPolicy(round_to=2),) * nrt,
                         host_device=CompressionPolicy(round_to=2))
    return plan, dataclasses.replace(plan, int8_kv=True)


def _weights(inputs, mesh_cfg):
    """``(cfg, spec tree, [global storage of v0, v1])`` at ``mesh_cfg``
    (no process group needed)."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.convert import convert_lm_params
    from repro_torch.dist.spec import build_spec_tree, tree_to_storage
    from repro_torch.models.init import init_params

    cfg = reduced(get_config("qwen3-1.7b"))
    _, metas = init_params(cfg, device="meta", tp=mesh_cfg.tp)
    spec, whole = None, []
    for v in (0, 1):
        params = convert_lm_params(cfg, _params(inputs, v), device="cpu", tp=mesh_cfg.tp)
        spec = build_spec_tree(params, metas, mesh_cfg)
        whole.append(tree_to_storage(params, spec, mesh_cfg))
    return cfg, spec, whole


class _Ctx:
    """What a fleet run needs: config, mesh, spec tree, the two versions'
    storage (the rank's blocks on a mesh) and the plans."""

    def __init__(self, inputs, mesh_cfg, rank=0):
        from repro_torch.dist.spec import tree_to_local
        from repro_torch.launch.mesh import make_mesh_from_cfg

        self.cfg, self.spec, whole = _weights(inputs, mesh_cfg)
        self.storages = [tree_to_local(w, self.spec, mesh_cfg, rank) for w in whole]
        self.mesh_cfg = mesh_cfg
        self.mesh = make_mesh_from_cfg(mesh_cfg)
        self.plan, self.plan8 = _plans(self.cfg)

    def engine(self, plan=None, storage=None, **kw):
        from repro_torch.serve.engine import ServeEngine

        kw = {"max_slots": SLOTS, "cache_capacity": CAP, "paged": True, "page_size": PAGE, **kw}
        return ServeEngine(self.cfg, self.mesh_cfg, self.mesh, self.spec,
                           self.storages[0] if storage is None else storage,
                           plan=plan or self.plan, **kw)

    def worker(self, plan=None):
        from repro_torch.fleet import PrefillWorker

        return PrefillWorker("w0", self.cfg, self.mesh_cfg, self.mesh, self.spec,
                             plan=plan or self.plan, cache_capacity=CAP, page_size=PAGE)

    def publisher(self, plan):
        from repro_torch.fleet import WeightPublisher

        return WeightPublisher(self.cfg, self.spec, plan=plan, mesh_cfg=self.mesh_cfg)


def _fleet(ctx, case):
    """One router run of ``case`` (scenario_fleet.py's matrix)."""
    from repro_torch.fleet import DecodeReplica, FleetRouter
    from repro_torch.plan import SamplingParams
    from repro_torch.serve.api import Request

    plan = ctx.plan8 if case == "int8" else ctx.plan
    reqs = _requests(ctx.cfg.vocab_size, Request, sampled=case == "sampled",
                     sampling_cls=SamplingParams)
    router = FleetRouter([DecodeReplica(f"r{i}", ctx.engine(plan)) for i in range(2)],
                         [ctx.worker(plan)])
    pub = ctx.publisher(plan)
    p0 = pub.publish(ctx.storages[0])
    router.publish(p0)
    state, out, on_tick = {"done": False}, {}, None
    if case == "join_leave":
        def on_tick(r):
            if not state["done"] and r.ticks >= 2:
                state["done"] = True
                r.add_replica(DecodeReplica("r2", ctx.engine(plan)))
                r.remove_replica("r0")
    elif case == "refresh":
        wave_b = _requests(ctx.cfg.vocab_size, Request, rid_base=len(reqs), seed=11)
        p1 = pub.publish(ctx.storages[1], step=1)
        out["p1"] = _digest(p1)

        def on_tick(r):
            if not state["done"] and len(r.results) >= 2:
                state["done"] = True
                r.publish(p1)
                for req in wave_b:
                    r.submit(req)
    results = router.run(list(reversed(reqs)) if case == "reversed" else reqs, on_tick=on_tick)
    out.update(streams={rid: list(r.tokens) for rid, r in results.items()},
               hops=list(router.fabric.hops), placements=dict(router.placements),
               summary=router.wire_summary(), parcel_bytes=p0.nbytes, p0=_digest(p0),
               hooked=on_tick is None or state["done"],
               replicas=[r.name for r in router.replicas],
               step_logs=[[dict(x) for x in r.engine.step_log] for r in router.replicas],
               worker_log=[dict(x) for x in router.workers[0].step_log])
    out["restored"] = {v: {k: x.numpy() for k, x in _leaves(router.versions[v]).items()}
                       for v in router.versions}
    return out


def _leaves(tree):
    from repro_torch.checkpoint.sharded import leaf_entries

    return dict(leaf_entries(tree))


def _pools(engine):
    return [x.clone() for g in engine._caches for node in g.values()
            for x in dataclasses.astuple(node)]


def _chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def _phase19():
    """``chip_smoke.py`` phase 19 at the reduced config on the CPU, with the
    references it takes (phase 7's requests and static streams, phase 15
    (a)'s sampled and (b)'s paged int8 engine streams) made by the same
    port calls: what phase 24 is held to."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.launch.serve import build_requests
    from repro_torch.launch.serve import setup as serve_setup
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.engine import ServeEngine, generate_static

    c = _chip_smoke()
    cfg = reduced(get_config("qwen3-1.7b"))
    dev = torch.device("cpu")
    mesh_cfg, spec, storage = serve_setup(cfg, seed=0, device=dev)
    plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2)
    plan8 = dataclasses.replace(plan, int8_kv=True)
    requests = build_requests((32, 32, 24, 16, 12), 4, cfg.vocab_size)

    def run(reqs, p, **kw):
        eng = ServeEngine(cfg, mesh_cfg, None, spec, storage, plan=p, max_slots=SLOTS,
                          cache_capacity=36, **kw)
        return {rid: r.tokens for rid, r in eng.run(reqs).items()}

    refs = {"requests": requests,
            "static": generate_static(cfg, mesh_cfg, None, spec, storage, requests, plan=plan),
            "sampled": run(c.sampled_requests(requests), plan),
            "int8": run(requests, plan8, paged=True, page_size=PAGE)}
    return c.fleet_path(torch, dev, refs, cfg=cfg, page=PAGE, shared=16, tails=(8, 12, 16))


def _mesh_rank(rank, inputs, phase19):
    """Everything the port computes on one rank of the 1×2 mesh, as plain
    data; last, ``chip_smoke.py`` phase 24's rank at the reduced config,
    held to ``phase19``."""
    from repro_torch.dist import comm
    from repro_torch.dist.spec import MeshCfg
    from repro_torch.serve.api import Request
    from repro_torch.serve.step import serve_wire_table
    from repro_torch.train.step import COLLECTIVE_CLASSES
    from repro_torch.transport import pack_kv_pages, unpack_kv_pages

    ctx = _Ctx(inputs, MeshCfg(tp=TP, compress_min_size=MIN_SIZE), rank)
    out = {"cases": {case: _fleet(ctx, case) for case in CASES}}
    reqs = _requests(ctx.cfg.vocab_size, Request)

    # the worker's KV parcels and its prefill collectives against serve_wire_table
    worker, out["kv"], out["worker_wire"] = ctx.worker(), {}, []
    for r in reqs:
        first = len(comm.LOG)
        pages, tok = worker.prefill(ctx.storages[0], r)
        padded = -(-len(r.prompt_ids) // PAGE) * PAGE
        measured = comm.wire_by_traffic(comm.LOG[first:])
        table = serve_wire_table(ctx.plan, ctx.cfg, ctx.spec, ctx.mesh_cfg, rows=1,
                                 tokens=padded)
        out["worker_wire"].append(({k: measured.get(k, 0) for k in COLLECTIVE_CLASSES},
                                   {k: table[k] for k in COLLECTIVE_CLASSES},
                                   measured.get("relayout", 0), measured.get("logits", 0)))
        parcel = pack_kv_pages(pages, ctx.plan.kv_migration_policy())
        out["kv"][r.rid] = ([{k: {a: x.numpy() for a, x in node.items()}
                              for k, node in g.items()} for g in pages], tok, parcel.nbytes)

    # admit_pages against a local admission, both at tp 2
    out["pools_equal"] = {}
    for tag, plan in (("fp32", ctx.plan), ("int8", ctx.plan8)):
        local, migr, w = ctx.engine(plan), ctx.engine(plan), ctx.worker(plan)
        for e in (local, migr):
            e.begin_stream()
        for req in reqs[:SLOTS]:
            local.admit(req)
            hits = migr.can_admit(req)[1]
            pages, tok = w.prefill(ctx.storages[0], req, n_hits=len(hits))
            parcel = pack_kv_pages(pages, plan.kv_migration_policy())
            migr.admit_pages(req, unpack_kv_pages(parcel), n_hits=len(hits), first_tok=tok)
        same = [torch.equal(a, b) for a, b in zip(_pools(local), _pools(migr), strict=True)]
        out["pools_equal"][tag] = (same, bool((local._table == migr._table).all()),
                                   local._next_tok.tolist() == migr._next_tok.tolist())

    # swap_weights against a fresh engine, plain and weight-stationary
    out["swap"] = {}
    for ws in (False, True):
        eng = ctx.engine(weight_stationary=ws)
        base = {rid: r.tokens for rid, r in eng.run(reqs[:2]).items()}
        eng.swap_weights(ctx.storages[1])
        swapped = {rid: r.tokens for rid, r in eng.run(reqs[:2]).items()}
        fresh = {rid: r.tokens for rid, r in ctx.engine(
            storage=ctx.storages[1], weight_stationary=ws).run(reqs[:2]).items()}
        out["swap"][ws] = (base, swapped, fresh)
    out["kv1"] = _kv1(rank, ctx)
    # chip_smoke.py's rank pair as main() runs it: phase 23 (a), (c), phase
    # 18 (b), (c), then phase 24 held to phase19
    c = _chip_smoke()
    bc = c.mesh_bc_args(ctx.cfg, phase19["requests"]["greedy"], gen=4, window=16)
    out["pair"] = c._pair_rank(rank, "cpu", PAIR_S_LOC, 2, ctx.cfg, (16, 8), 4, c.FEAT_SPEC_K,
                               bc, phase19)
    out["phase24"] = out["pair"].pop("fleet")
    return out


PAIR_S_LOC = 4096  # phase 23 (a)'s chunked gather at a small shard here


def _kv1(rank, ctx):
    """One kv head under tp 2 (each rank holds it, replicated): a worker's
    pages for two requests and whether a migrated admission of them leaves
    the pools as a local one does. Weights from seed 0 (the port's init
    gives the same tree at tp 1 and 2 at these widths)."""
    from repro_torch.fleet import PrefillWorker
    from repro_torch.launch.serve import setup as serve_setup
    from repro_torch.serve.api import Request
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.transport import pack_kv_pages, unpack_kv_pages

    cfg = _kv1_cfg(ctx.cfg)
    _, spec, storage = serve_setup(cfg, seed=0, device=torch.device("cpu"),
                                   mesh_cfg=ctx.mesh_cfg, rank=rank)
    engines = [ServeEngine(cfg, ctx.mesh_cfg, ctx.mesh, spec, storage, plan=ctx.plan,
                           max_slots=SLOTS, cache_capacity=CAP, paged=True, page_size=PAGE)
               for _ in range(2)]
    worker = PrefillWorker("w0", cfg, ctx.mesh_cfg, ctx.mesh, spec, plan=ctx.plan,
                           cache_capacity=CAP, page_size=PAGE)
    pages_out = []
    local, migr = engines
    for e in engines:
        e.begin_stream()
    for req in _requests(cfg.vocab_size, Request)[:SLOTS]:
        local.admit(req)
        hits = migr.can_admit(req)[1]
        pages, tok = worker.prefill(storage, req, n_hits=len(hits))
        pages_out.append(([{k: {a: x.numpy() for a, x in node.items()} for k, node in g.items()}
                           for g in pages], tok, len(hits)))
        migr.admit_pages(req, unpack_kv_pages(pack_kv_pages(pages, ctx.plan.kv_migration_policy())),
                         n_hits=len(hits), first_tok=tok)
    same = [torch.equal(a, b) for a, b in zip(_pools(local), _pools(migr), strict=True)]
    return pages_out, (same, bool((local._table == migr._table).all()),
                       local._next_tok.tolist() == migr._next_tok.tolist())


def _kv1_cfg(cfg):
    return dataclasses.replace(cfg, num_kv_heads=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, [per-rank port outputs at 1×2], one-device
    outputs, inputs): the reference subprocess runs while the port's ranks
    and the one-device matrix do."""
    import pickle

    from repro_torch.dist.spec import MeshCfg
    from repro_torch.launch.mesh import spawn_ranks

    tmp = tmp_path_factory.mktemp("fleet_mesh")
    inputs = _inputs()
    inp, out = str(tmp / "inputs.npz"), str(tmp / "ref.pkl")
    np.savez(inp, **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), inp, out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as phase19_text:
            phase19 = _phase19()
        ranks = spawn_ranks(_mesh_rank, TP, inputs, phase19)
        one = _Ctx(inputs, MeshCfg(compress_min_size=MIN_SIZE))
        single = {"ctx": one, "cases": {case: _fleet(one, case) for case in CASES},
                  "phase19": phase19, "phase19_text": phase19_text.getvalue()}
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        torch.set_num_threads(n)
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference failed:\n{stdout[-3000:]}\n{stderr[-3000:]}"
    with open(out, "rb") as f:
        ref = pickle.load(f)
    return ref, ranks, single, inputs


@pytest.mark.parametrize("case", CASES)
def test_tp2_router_equals_one_device_fleet(runs, case):
    """At 1×2 every rank's router gives the one-device fleet's streams,
    placements, replica set and migrated pages; its ``kv_migration`` hops
    equal one device's hop for hop (src, dst, bytes) and its
    ``weight_publish`` hops are the 1×2 parcel's bytes at every install;
    both classes equal ``fleet_migration_bytes`` on every rank."""
    from repro_torch.roofline.analysis import fleet_migration_bytes

    _, ranks, single, _ = runs
    one = single["cases"][case]
    ctx = single["ctx"]
    plan = ctx.plan8 if case == "int8" else ctx.plan
    for r, rk in enumerate(ranks):
        got = rk["cases"][case]
        assert got["hooked"], f"rank {r}: the {case} hook never fired mid-run"
        assert got["streams"] == one["streams"], f"rank {r}"
        assert got["placements"] == one["placements"] and got["replicas"] == one["replicas"]
        kv = [h for h in got["hops"] if h["cls"] == "kv_migration"]
        assert kv == [h for h in one["hops"] if h["cls"] == "kv_migration"], f"rank {r}"
        pub = [h for h in got["hops"] if h["cls"] == "weight_publish"]
        assert [(h["src"], h["dst"]) for h in pub] == [
            (h["src"], h["dst"]) for h in one["hops"] if h["cls"] == "weight_publish"]
        assert {h["bytes"] for h in pub} == {got["parcel_bytes"]}
        ws = got["summary"]
        assert ws["migrated_pages"] == one["summary"]["migrated_pages"]
        analytic = fleet_migration_bytes(plan, ctx.cfg, page_size=PAGE,
                                         migrated_pages=ws["migrated_pages"],
                                         int8_kv=plan.int8_kv,
                                         publish_wire_bytes=got["parcel_bytes"],
                                         publish_installs=ws["publish_installs"])
        for cls in ("kv_migration", "weight_publish"):
            assert ws[cls] == analytic[cls], (r, cls)
        assert got["worker_log"] == one["worker_log"]
        assert got["step_logs"] == one["step_logs"]
    assert ranks[1]["cases"][case] == {**ranks[0]["cases"][case],
                                       "restored": ranks[1]["cases"][case]["restored"]}


def test_tp2_greedy_streams_equal_reference_static(runs):
    """The greedy fleets' streams at 1×2 equal the reference's
    ``generate_static`` at 1×2: version 0 at fp32 and int8 KV, and the
    refresh wave under version 1."""
    ref, ranks, _, _ = runs
    for rk in ranks:
        c = rk["cases"]
        for case in ("fifo", "reversed", "join_leave"):
            assert c[case]["streams"] == ref["static"]["fp32"], case
        assert c["int8"]["streams"] == ref["static"]["int8"]
        stream = c["refresh"]["streams"]
        want = {**ref["static"]["fp32"], **ref["static"]["v1"]}
        assert stream == want


def test_tp2_weight_parcels_byte_equal_reference(runs):
    """The parcels published at 1×2 are the mesh's global storage: equal on
    both ranks and to the reference publisher's at 1×2 entry by entry, and
    to a pack of the global storage in one process; ``nbytes`` equals
    ``train_checkpoint_bytes(residuals=False)`` of it and ``manifest_bytes``.
    Each rank's restored blocks are bit-equal to its blocks of the global
    storage truncated to the parcel's widths."""
    from repro_torch.checkpoint.sharded import assign_widths, manifest_bytes
    from repro_torch.dist.spec import MeshCfg, tree_to_local
    from repro_torch.roofline.analysis import train_checkpoint_bytes
    from repro_torch.transport import pack_weight_parcel

    ref, ranks, _, inputs = runs
    mesh_cfg = MeshCfg(tp=TP, compress_min_size=MIN_SIZE)
    cfg, spec, whole = _weights(inputs, mesh_cfg)
    plan = _plans(cfg)[0]
    for r, rk in enumerate(ranks):
        assert rk["cases"]["refresh"]["p0"] == ref["parcels"][0], f"rank {r} v0"
        assert rk["cases"]["refresh"]["p1"] == ref["parcels"][1], f"rank {r} v1"
    widths = assign_widths(whole[0], spec, plan.round_tos)
    for v in (0, 1):
        parcel = pack_weight_parcel(whole[v], spec_tree=spec, round_tos=plan.round_tos,
                                    policy=plan.weight_publish_policy(), version=v, step=v)
        assert _digest(parcel) == ref["parcels"][v]
        assert not parcel.residuals
        assert parcel.nbytes == manifest_bytes(parcel.manifest_meta())["total"] == \
            train_checkpoint_bytes(whole[v], spec_tree=spec, round_tos=plan.round_tos,
                                   residuals=False)["total"] == \
            ranks[0]["cases"]["refresh"]["parcel_bytes"]
        for r, rk in enumerate(ranks):
            blocks = _leaves(tree_to_local(whole[v], spec, mesh_cfg, r))
            got = rk["cases"]["refresh"]["restored"][v]
            assert sorted(got) == sorted(blocks)
            for path, x in blocks.items():
                keep = np.uint32(0xFFFFFFFF << (8 * (4 - widths[path])) & 0xFFFFFFFF)
                want = x.numpy().view(np.uint32) & keep if widths[path] < 4 else x.numpy()
                np.testing.assert_array_equal(got[path].view(want.dtype), want,
                                              f"rank {r} v{v} {path}")


def test_tp2_kv_parcels_equal_one_device_worker(runs):
    """The tp-2 worker's pages carry every kv head (gathered over the model
    group): the one-device worker's shapes, dtypes, parcel bytes and first
    ids for the same request, values within ``KV_TOL`` of its pages and of
    the reference worker's at 1×2 where that runs (else its error is the
    one ROADMAP records), equal on both ranks."""
    from repro_torch.checkpoint.sharded import leaf_entries
    from repro_torch.serve.api import Request
    from repro_torch.transport import pack_kv_pages

    ref, ranks, single, _ = runs
    ctx = single["ctx"]
    worker = ctx.worker()
    for req in _requests(ctx.cfg.vocab_size, Request):
        pages, first = worker.prefill(ctx.storages[0], req)
        nbytes = pack_kv_pages(pages, ctx.plan.kv_migration_policy()).nbytes
        want = dict(leaf_entries(pages))
        rank0 = dict(leaf_entries(ranks[0]["kv"][req.rid][0]))
        for r, rk in enumerate(ranks):
            got_pages, got_first, got_bytes = rk["kv"][req.rid]
            assert (got_first, got_bytes) == (first, nbytes), (r, req.rid)
            got = dict(leaf_entries(got_pages))
            assert sorted(got) == sorted(want)
            for path, x in want.items():
                assert got[path].shape == tuple(x.shape) and got[path].dtype == x.numpy().dtype
                assert got[path].shape[3] == ctx.cfg.num_kv_heads
                np.testing.assert_allclose(got[path], x.numpy(), **KV_TOL)
                np.testing.assert_array_equal(got[path], rank0[path])
        if isinstance(ref["worker"], dict):
            jpages, jfirst = ref["worker"][req.rid]
            assert jfirst == first
            jwant = dict(leaf_entries(jpages))
            for path, x in rank0.items():
                np.testing.assert_allclose(x, jwant[path], **KV_TOL)
    if not isinstance(ref["worker"], dict):
        assert "ShardingTypeError" in ref["worker"], ref["worker"]


@pytest.mark.parametrize("tag", ["fp32", "int8", "kv1"])
def test_tp2_admit_pages_pools_equal_local_admission(runs, tag):
    """At tp 2 a migrated admission (the global pages, each rank installing
    its kv heads) leaves every rank's pools, page table and next ids
    bit-equal to a local admission of the same requests (a shared-prefix
    hit included): the mesh version of
    ``test_torch_fleet.py::test_admit_pages_pools_equal_local_admission``;
    ``kv1``: one kv head, replicated on both ranks."""
    _, ranks, _, _ = runs
    for r, rk in enumerate(ranks):
        same, table, next_tok = rk["kv1"][1] if tag == "kv1" else rk["pools_equal"][tag]
        assert same and all(same), (r, same)
        assert table and next_tok, r


def test_tp2_kv_parcels_with_one_kv_head(runs):
    """Where ``Kv < tp`` the ranks hold one kv head each, the same one: the
    worker's export keeps one copy, so its pages are one device's (within
    ``KV_TOL``: one head, ``(R, n_new, page, 1, hd)``), equal on both
    ranks."""
    from repro_torch.checkpoint.sharded import leaf_entries
    from repro_torch.fleet import PrefillWorker
    from repro_torch.launch.serve import setup as serve_setup
    from repro_torch.serve.api import Request

    _, ranks, single, _ = runs
    ctx = single["ctx"]
    cfg = _kv1_cfg(ctx.cfg)
    mesh_cfg, spec, storage = serve_setup(cfg, seed=0, device=torch.device("cpu"),
                                          mesh_cfg=ctx.mesh_cfg)
    worker = PrefillWorker("w0", cfg, mesh_cfg, None, spec, plan=ctx.plan, cache_capacity=CAP,
                           page_size=PAGE)
    for i, req in enumerate(_requests(cfg.vocab_size, Request)[:SLOTS]):
        got0 = ranks[0]["kv1"][0][i]
        pages, tok = worker.prefill(storage, req, n_hits=got0[2])
        want = dict(leaf_entries(pages))
        for rk in ranks:
            got, got_tok, _ = rk["kv1"][0][i]
            assert got_tok == tok
            got = dict(leaf_entries(got))
            assert sorted(got) == sorted(want)
            for path, x in want.items():
                assert got[path].shape == tuple(x.shape) and got[path].shape[3] == 1
                np.testing.assert_allclose(got[path], x.numpy(), **KV_TOL)


@pytest.mark.parametrize("ws", [False, True], ids=["plain", "weight-stationary"])
def test_tp2_swap_weights_equals_fresh_engine(runs, ws):
    """``swap_weights`` at tp 2 with the rank's blocks of version 1 gives a
    fresh engine's streams from them (re-placed when weight-stationary), on
    both ranks, and not version 0's."""
    _, ranks, _, _ = runs
    for rk in ranks:
        base, swapped, fresh = rk["swap"][ws]
        assert swapped == fresh != base
    assert ranks[0]["swap"][ws] == ranks[1]["swap"][ws]


def test_tp2_worker_prefill_wire_equals_serve_wire_table(runs):
    """Each tp-2 worker prefill moves what ``serve_wire_table``'s prefill row
    prices at its padded length (one row) in every priced class; the export's
    kv-head gather is logged as ``relayout`` (unpriced) beside the logits
    gather."""
    _, ranks, _, _ = runs
    for rk in ranks:
        assert len(rk["worker_wire"]) == len(TAILS)
        for measured, table, relayout, logits in rk["worker_wire"]:
            assert measured == table
            assert measured["activations"] > 0 and relayout > 0 and logits > 0


def test_launcher_at_2x2_with_refresh_and_check_static():
    """``launch.fleet --mesh 2x2`` (4 gloo ranks) with ``--check-static``, a
    refresh and the fabric pin exits 0 and prints the one-device run's
    lines but the timing line."""
    from repro_torch.launch import fleet as launch

    argv = ["--arch", "qwen3-1.7b", "--reduced", "--replicas", "2", "--workers", "1",
            "--prompt-lens", "8,6,8,6", "--gen", "4", "--page-size", "8", "--refresh-at", "2",
            "--check-static", "--device", "cpu"]
    text = {}
    for mesh in ("1x1", "2x2"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            launch.main(argv + ["--mesh", mesh])
        text[mesh] = [x for x in out.getvalue().splitlines() if not x.startswith("fleet:")]
    assert text["2x2"] == text["1x1"]
    assert any(x.startswith("fabric == fleet_migration_bytes") for x in text["2x2"])
    assert any(x.startswith("check-static: 8 streams bit-exact") for x in text["2x2"])


def test_chip_smoke_fleet_mesh_phase_rehearses_on_cpu(runs, capsys):
    """Phase 24's rank function (``chip_smoke._fleet_mesh_rank``) ran on
    both ranks at the reduced config with the plain versions (launch
    counts, memory and the kernels' checks are read on a card only), held
    to phase 19's run at that config: its report holds the ranks to each
    other and prints its lines."""
    c = _chip_smoke()
    _, ranks, single, _ = runs
    out = c.fleet_mesh_report([rk["phase24"] for rk in ranks], "cpu")
    text = capsys.readouterr().out
    phase19 = single["phase19"]
    assert "phase 19:" in single["phase19_text"]
    assert ranks[0]["phase24"]["streams"] == phase19["streams"]
    assert ranks[0]["phase24"]["ws"]["publish_installs"] == phase19["ws"]["publish_installs"] == 5
    assert ranks[0]["phase24"]["diverged"] == []
    assert out["launches"] == {k: 0 for k in out["launches"]}
    for line in ("(a)+(c) at 1x2: 13 requests", "== fleet_migration_bytes on both ranks",
                 "rank 1 ms: decode a replica tick"):
        assert line in text, line


def test_chip_smoke_pair_rank_rehearses_on_cpu(runs, capsys):
    """``chip_smoke._pair_rank``, the rank pair ``main()`` spawns for phase
    23 (a) and (c), phase 18 (b) and (c) (on ``mesh_bc_args``) and phase 24,
    ran on both ranks at the reduced config: (a) timed every size and
    chunk count, (c)'s streams and wire agree on both ranks, and phase 18
    (b), (c)'s report holds the speculative engines to the 1×2 engine and
    the ring engine to the windowed static run, with the plain versions
    (no launches)."""
    c = _chip_smoke()
    _, ranks, _, _ = runs
    pairs = [rk["pair"] for rk in ranks]
    for p in pairs:
        assert sorted(p["a"]["all_gather"]) == sorted(c.ACCT_SIZES)
        assert sorted(p["a"]["chunks"]) == sorted(c.ACCT_CHUNKS)
        assert p["c"]["wire"] == p["c"]["logged"] and p["c"]["rounds"] > 0
    assert pairs[0]["c"]["streams"] == pairs[1]["c"]["streams"]
    bc = c.mesh_serve_report([p["mesh_bc"] for p in pairs], "the CPU")
    assert bc["launches"] == dict.fromkeys(bc["launches"], 0)
    text = capsys.readouterr().out
    assert "acceptance 1.0000" in text  # the self draft at 1×2
    assert "ring == windowed static" in text


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
