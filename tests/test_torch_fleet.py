"""The serving fleet slice: port vs the JAX reference.

Both packages serve reduced qwen3-1.7b (2 layers, d 256, hd 64) from the
same weights (the reference's ``init_params(cfg, PRNGKey(0))``, and
``PRNGKey(1)`` for a refresh, carried across by ``convert_lm_params``),
with ``tests/test_fleet.py``'s plan (``round_to=2`` weights and
host_device entry), ``compress_min_size=4096``, pages of 8 tokens and 2
slots a replica. The router runs the matrix of
``tests/scenarios/scenario_fleet.py`` at one device (that scenario runs
at tp 2, where the reference's engine fails): FIFO, a reversed arrival
order, a replica joining and one leaving, int8 KV, a mid-run weight
refresh, and sampled requests.

Tolerances: none. Parcels, hop logs, byte counts and token streams must
be exactly equal; restored weights bit-equal.
"""
import contextlib
import dataclasses
import io
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.sharded import manifest_bytes as j_manifest_bytes
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.dist.spec import MeshCfg as JMesh
from repro.dist.spec import build_spec_tree as j_build_spec_tree
from repro.dist.spec import tree_to_storage as j_tree_to_storage
from repro.fleet import DecodeReplica as JReplica
from repro.fleet import FleetRouter as JRouter
from repro.fleet import PrefillWorker as JWorker
from repro.fleet import WeightPublisher as JPublisher
from repro.launch import fleet as j_launch
from repro.models.init import init_params as j_init_params
from repro.plan import PrecisionPlan as JPlan
from repro.plan import SamplingParams as JSampling
from repro.roofline.analysis import fleet_migration_bytes as j_fleet_bytes
from repro.serve import engine as jeng
from repro.transport import CompressionPolicy as JPolicy
from repro.transport import fabric as jfab
from repro_torch.checkpoint.sharded import leaf_entries, manifest_bytes, read_meta
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import convert_lm_params
from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_storage
from repro_torch.fleet import (
    DecodeReplica,
    FleetRouter,
    PrefillWorker,
    ReplicaError,
    RouterError,
    WeightPublisher,
    check_fleet_arch,
)
from repro_torch.launch import fleet as launch
from repro_torch.models.init import init_params
from repro_torch.plan import PrecisionPlan, SamplingParams
from repro_torch.roofline.analysis import fleet_migration_bytes, train_checkpoint_bytes
from repro_torch.serve import engine as teng
from repro_torch.serve.api import Request
from repro_torch.transport import (
    CompressionPolicy,
    FabricChannel,
    FabricError,
    pack_kv_pages,
    pack_weight_parcel,
    unpack_kv_pages,
    unpack_weight_parcel,
)

MIN_SIZE = 4096
PAGE = 8
SLOTS = 2
CAP = 28  # scenario_fleet.py's capacity
GEN = 5
TAILS = (9, 4, 12, 7, 10)  # scenario_fleet.py's tails after a one-page shared prefix
SAMPLING = dict(temperature=0.8, top_p=0.95, top_k=40)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduced(j_get_config("qwen3-1.7b"))
    tcfg = reduced(get_config("qwen3-1.7b"))
    jmesh, tmesh = JMesh(tp=1, dp=1, compress_min_size=MIN_SIZE), MeshCfg(compress_min_size=MIN_SIZE)
    _, tmetas = init_params(tcfg, device="meta")
    out = dict(jcfg=jcfg, tcfg=tcfg, jmesh=jmesh, tmesh=tmesh)
    for v in (0, 1):
        params, metas = j_init_params(jcfg, jax.random.PRNGKey(v), tp=1)
        jspec = j_build_spec_tree(params, metas, jmesh)
        tparams = convert_lm_params(tcfg, _np(params), device="cpu")
        tspec = build_spec_tree(tparams, tmetas, tmesh)
        out.update({f"jstorage{v}": j_tree_to_storage(params, jspec, jmesh),
                    f"tstorage{v}": tree_to_storage(tparams, tspec, tmesh),
                    "jspec": jspec, "tspec": tspec, f"tparams{v}": tparams})
    nrt = jcfg.num_groups + 1
    out["jplan"] = JPlan(weights=(JPolicy(round_to=2),) * nrt, host_device=JPolicy(round_to=2))
    out["tplan"] = PrecisionPlan(weights=(CompressionPolicy(round_to=2),) * nrt,
                                 host_device=CompressionPolicy(round_to=2))
    return out


def _requests(vocab, cls, *, rid_base=0, seed=3, sampled=False, sampling_cls=None):
    """scenario_fleet.py's requests: a one-page shared prefix, then tails."""
    rng = np.random.default_rng(seed)
    shared = tuple(int(t) for t in rng.integers(0, vocab, PAGE))
    out = []
    for i, tail in enumerate(TAILS):
        kw = {}
        if sampled:
            kw["sampling"] = sampling_cls(**SAMPLING, seed=100 + i)
        out.append(cls(rid=rid_base + i, max_new=GEN, **kw,
                       prompt_ids=shared + tuple(int(t) for t in rng.integers(0, vocab, tail))))
    return out


# ---------------------------------------------------------------------------
# the router matrix: both packages, each case once
# ---------------------------------------------------------------------------

CASES = ("fifo", "reversed", "join_leave", "int8", "refresh", "sampled")


def _pkg(pkg, s):
    """Package ``pkg``'s ("ref" or "port") classes and the setup's objects;
    its fleet members are built once and reused across the cases, as
    ``scenario_fleet.py`` reuses its engines (every ``DecodeReplica``
    starts a fresh stream)."""
    if pkg == "ref":
        p = dict(cfg=s["jcfg"], mesh=s["jmesh"], spec=s["jspec"], Req=jeng.Request,
                 Samp=JSampling, Eng=jeng.ServeEngine, Rep=JReplica, Wrk=JWorker, Rtr=JRouter,
                 Pub=JPublisher, store0=s["jstorage0"], store1=s["jstorage1"], plan=s["jplan"])
    else:
        p = dict(cfg=s["tcfg"], mesh=s["tmesh"], spec=s["tspec"], Req=Request,
                 Samp=SamplingParams, Eng=teng.ServeEngine, Rep=DecodeReplica, Wrk=PrefillWorker,
                 Rtr=FleetRouter, Pub=WeightPublisher, store0=s["tstorage0"],
                 store1=s["tstorage1"], plan=s["tplan"])
    p["plan8"] = dataclasses.replace(p["plan"], int8_kv=True)
    for tag, plan in (("", p["plan"]), ("8", p["plan8"])):
        p["engines" + tag] = [
            p["Eng"](p["cfg"], p["mesh"], None, p["spec"], p["store0"], plan=plan,
                     max_slots=SLOTS, cache_capacity=CAP, paged=True, page_size=PAGE)
            for _ in range(3 if tag == "" else 2)]
        p["worker" + tag] = p["Wrk"]("w0", p["cfg"], p["mesh"], None, p["spec"], plan=plan,
                                     cache_capacity=CAP, page_size=PAGE)
    return p


def _fleet(p, case):
    """One router run of ``case`` with package members ``p`` (:func:`_pkg`)."""
    tag = "8" if case == "int8" else ""
    plan, engines = p["plan" + tag], p["engines" + tag]
    cfg, Rep = p["cfg"], p["Rep"]
    reqs = _requests(cfg.vocab_size, p["Req"], sampled=case == "sampled",
                     sampling_cls=p["Samp"])
    router = p["Rtr"]([Rep("r0", engines[0]), Rep("r1", engines[1])], [p["worker" + tag]])
    pub = p["Pub"](cfg, p["spec"], plan=plan)
    p0 = pub.publish(p["store0"])
    router.publish(p0)
    state, extra, on_tick = {"done": False}, {}, None
    if case == "join_leave":
        def on_tick(r):
            if not state["done"] and r.ticks >= 2:
                state["done"] = True
                r.add_replica(Rep("r2", engines[2]))
                r.remove_replica("r0")
    elif case == "refresh":
        wave_b = _requests(cfg.vocab_size, p["Req"], rid_base=len(reqs), seed=11)
        p1 = pub.publish(p["store1"], step=1)
        extra.update(wave_b=wave_b, p1=p1)

        def on_tick(r):
            if not state["done"] and len(r.results) >= 2:
                state["done"] = True
                r.publish(p1)
                for req in wave_b:
                    r.submit(req)
    results = router.run(list(reversed(reqs)) if case == "reversed" else reqs, on_tick=on_tick)
    if on_tick is not None:
        assert state["done"], f"{case}: the hook never fired mid-run"
    extra["replicas"] = [r.name for r in router.replicas]
    extra["step_logs"] = [[dict(x) for x in r.engine.step_log] for r in router.replicas]
    extra["worker_log"] = [dict(x) for x in router.workers[0].step_log]
    router.workers[0].step_log.clear()
    return {"streams": {rid: list(r.tokens) for rid, r in results.items()},
            "hops": list(router.fabric.hops), "placements": dict(router.placements),
            "summary": router.wire_summary(), "parcel_bytes": p0.nbytes, "plan": plan,
            "requests": reqs, "extra": extra}


@pytest.fixture(scope="module")
def runs(setup):
    out = {case: {} for case in CASES}
    for pkg in ("ref", "port"):
        p = _pkg(pkg, setup)
        for case in CASES:
            out[case][pkg] = _fleet(p, case)
    return out


@pytest.mark.parametrize("case", CASES)
def test_router_matrix_equals_reference_and_single_engine(setup, runs, case):
    """The port's router streams, hop log (class, src, dst, bytes, in
    order), placements and summary equal the reference router's; its
    streams equal a single paged engine's (before a refresh) and, after
    one, a fresh engine's from the weights restored from the published
    parcel; the hop log equals ``fleet_migration_bytes``."""
    s, ref, port = setup, runs[case]["ref"], runs[case]["port"]
    assert port["streams"] == ref["streams"]
    assert port["hops"] == ref["hops"]
    assert port["placements"] == ref["placements"]
    assert port["summary"] == ref["summary"]
    assert port["extra"]["replicas"] == ref["extra"]["replicas"]
    plan, reqs = port["plan"], port["requests"]
    single = teng.ServeEngine(s["tcfg"], s["tmesh"], None, s["tspec"], s["tstorage0"], plan=plan,
                              max_slots=SLOTS, cache_capacity=CAP, paged=True, page_size=PAGE)
    want = {rid: r.tokens for rid, r in single.run(reqs).items()}
    assert {r.rid: port["streams"][r.rid] for r in reqs} == want
    if case == "refresh":
        restored = unpack_weight_parcel(port["extra"]["p1"], s["tstorage0"])
        single.swap_weights(restored)
        fresh = {rid: r.tokens for rid, r in single.run(port["extra"]["wave_b"]).items()}
        assert {rid: port["streams"][rid] for rid in fresh} == fresh
        assert fresh != {r.rid: want[r.rid - len(reqs)] for r in port["extra"]["wave_b"]}
        assert {m["version"] for m in port["placements"].values()} == {0, 1}
    if case == "join_leave":
        assert port["extra"]["replicas"] == ["r1", "r2"]
        assert port["summary"]["publish_installs"] == 3
    if case == "fifo":
        assert len({m["replica"] for m in port["placements"].values()}) == 2
    ws = port["summary"]
    analytic = fleet_migration_bytes(plan, s["tcfg"], page_size=PAGE,
                                     migrated_pages=ws["migrated_pages"], int8_kv=plan.int8_kv,
                                     publish_wire_bytes=port["parcel_bytes"],
                                     publish_installs=ws["publish_installs"])
    for cls in ("kv_migration", "weight_publish"):
        assert ws[cls] == analytic[cls], cls
    assert port["extra"]["worker_log"] == ref["extra"]["worker_log"]
    assert port["extra"]["step_logs"] == ref["extra"]["step_logs"]


def test_migrated_records_and_static(setup, runs):
    """A replica's step records count the parcels it took in
    ``kv_migration``; the FIFO streams equal ``generate_static``."""
    s = setup
    for case in ("fifo", "int8"):
        port = runs[case]["port"]
        for name, log in zip(port["extra"]["replicas"], port["extra"]["step_logs"]):
            assert sum(r["kv_migration"] for r in log) == sum(
                h["bytes"] for h in port["hops"] if h["cls"] == "kv_migration" and h["dst"] == name)
    reqs = runs["fifo"]["port"]["requests"]
    static = teng.generate_static(s["tcfg"], s["tmesh"], None, s["tspec"], s["tstorage0"], reqs,
                                  plan=s["tplan"])
    assert {r.rid: runs["fifo"]["port"]["streams"][r.rid] for r in reqs} == static


# ---------------------------------------------------------------------------
# analytic pricing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rt", [1, 2, 3, 4])
def test_kv_wire_width_matches_reference(rt):
    for it in (1, 2, 4):
        assert CompressionPolicy(round_to=rt).kv_wire_width(it) == \
            JPolicy(round_to=rt).kv_wire_width(it), it


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("rt", [1, 2, 4])
def test_fleet_migration_bytes_matches_reference(setup, rt, int8):
    s = setup
    kw = dict(page_size=PAGE, migrated_pages=9, int8_kv=int8, publish_wire_bytes=1000,
              publish_installs=3)
    for dtype_bytes in (4, 2):
        tp = PrecisionPlan(weights=(CompressionPolicy(round_to=2),),
                           host_device=CompressionPolicy(round_to=rt))
        jp = JPlan(weights=(JPolicy(round_to=2),), host_device=JPolicy(round_to=rt))
        assert fleet_migration_bytes(tp, s["tcfg"], dtype_bytes=dtype_bytes, **kw) == \
            j_fleet_bytes(jp, s["jcfg"], dtype_bytes=dtype_bytes, **kw)
        assert fleet_migration_bytes(CompressionPolicy(round_to=rt), s["tcfg"], **kw) == \
            j_fleet_bytes(JPolicy(round_to=rt), s["jcfg"], **kw)


def test_plan_fleet_policies_and_json(tmp_path):
    """The fabric's two policies resolve as the reference's (set, and by
    their defaults), and the plan file is byte-equal and loads across."""
    for kw in ({}, {"kv_migration": {"round_to": 1}, "weight_publish": {"round_to": 4}},
               {"host_device": {"round_to": 3}}):
        j = JPlan.from_json_dict({"weights": [{"round_to": 2}], **kw})
        t = PrecisionPlan.from_json_dict({"weights": [{"round_to": 2}], **kw})
        assert t.to_json() == j.to_json()
        for name in ("kv_migration_policy", "weight_publish_policy"):
            assert dataclasses.asdict(getattr(t, name)()) == dataclasses.asdict(getattr(j, name)())
        j.to_file(str(tmp_path / "j.json"))
        t.to_file(str(tmp_path / "t.json"))
        assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
        assert PrecisionPlan.from_file(str(tmp_path / "j.json")) == t


# ---------------------------------------------------------------------------
# fabric: KV page parcels
# ---------------------------------------------------------------------------


def _kv_trees(dtype, seed=11):
    """An export-shaped page tree (2 groups, one cache node each, ``(R,
    n_new, page, Kv, hd)`` leaves) as the reference's numpy arrays and the
    port's tensors, with the port's dict keys in another order."""
    rng = np.random.default_rng(seed)
    groups = []
    for _ in range(2):
        if dtype == "int8":
            node = {"k": rng.integers(-128, 128, (2, 3, PAGE, 2, 4)).astype(np.int8),
                    "v": rng.integers(-128, 128, (2, 3, PAGE, 2, 4)).astype(np.int8),
                    "k_scale": rng.standard_normal((2, 3, PAGE, 2)).astype(np.float32),
                    "v_scale": rng.standard_normal((2, 3, PAGE, 2)).astype(np.float32)}
        else:
            node = {a: rng.standard_normal((2, 3, PAGE, 2, 4)).astype(np.float32)
                    for a in ("k", "v")}
            if dtype == "bfloat16":
                node = {a: x.astype(ml_dtypes.bfloat16) for a, x in node.items()}
        groups.append({"p0": node})

    def port_leaf(x):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(x.copy())

    port = [{"p0": {a: port_leaf(g["p0"][a]) for a in reversed(list(g["p0"]))}} for g in groups]
    return groups, port


def _same_leaf(t, x):
    if t.dtype == torch.bfloat16:
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(x).view(np.int16))
    else:
        np.testing.assert_array_equal(t.numpy(), np.asarray(x))


@pytest.mark.parametrize("rt", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_kv_parcel_byte_equal_and_cross_unpack(dtype, rt):
    """The same pages make the same parcel in both packages, entry by
    entry (wire bytes and info); each package unpacks the other's bytes
    bitwise; the size is ``kv_wire_width`` an element."""
    jtree, ttree = _kv_trees(dtype)
    jp = jfab.pack_kv_pages(jtree, JPolicy(round_to=rt), meta={"rid": 5})
    tp = pack_kv_pages(ttree, CompressionPolicy(round_to=rt), meta={"rid": 5})
    assert tp.entries == jp.entries
    assert tp.nbytes == jp.nbytes and tp.meta == jp.meta == {"rid": 5}
    pol = CompressionPolicy(round_to=rt)
    assert tp.nbytes == sum(x.size * pol.kv_wire_width(x.dtype.itemsize)
                            for g in jtree for x in g["p0"].values())
    # the port's bytes through the reference's unpack, and the other way
    j_out = jfab.unpack_kv_pages(dataclasses.replace(jp, entries=tp.entries))
    t_out = unpack_kv_pages(dataclasses.replace(tp, entries=jp.entries), "cpu")
    for g, (jg, tg) in enumerate(zip(jtree, t_out)):
        assert list(tg["p0"]) == list(ttree[g]["p0"])  # the port's own dict order
        for a, x in jg["p0"].items():
            assert np.asarray(j_out[g]["p0"][a]).dtype == x.dtype
            np.testing.assert_array_equal(np.asarray(j_out[g]["p0"][a]).view(np.uint8),
                                          x.view(np.uint8))
            _same_leaf(tg["p0"][a], x)


def test_kv_parcel_truncated_wire_raises():
    parcel = pack_kv_pages({"k": torch.ones(2, PAGE)}, CompressionPolicy(round_to=2))
    wire, info = parcel.entries[0]
    with pytest.raises(FabricError):
        unpack_kv_pages(dataclasses.replace(parcel, entries=((wire[:-1], info),)))


def test_fabric_channel_typed_errors_and_summary():
    ch, jch = FabricChannel(), jfab.FabricChannel()
    parcel = pack_kv_pages({"k": torch.zeros(1, PAGE)}, CompressionPolicy(round_to=4))
    with pytest.raises(FabricError):
        ch.send(parcel, cls="gradients", src="a", dst="b")
    with pytest.raises(FabricError):
        ch.send(object(), cls="kv_migration", src="a", dst="b")
    for c in (ch, jch):
        c.send(parcel, cls="kv_migration", src="w0", dst="r0")
        c.send(parcel, cls="weight_publish", src="trainer", dst="r1")
    assert ch.hops == jch.hops
    assert ch.wire_summary() == jch.wire_summary()
    assert ch.wire_summary()["hops"] == {"kv_migration": 1, "weight_publish": 1}


# ---------------------------------------------------------------------------
# fabric: weight parcels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rt", [1, 2, 3, 4])
def test_weight_parcel_byte_equal_and_three_way_pin(setup, rt):
    """Port and reference parcels of the same storage are equal entry by
    entry; ``nbytes == manifest_bytes == train_checkpoint_bytes``; each
    package restores the other's bytes to the same weights (bitwise at
    round_to 4, which ships the residual tiers)."""
    s = setup
    nrt = s["tcfg"].num_groups + 1
    tp = pack_weight_parcel(s["tstorage0"], spec_tree=s["tspec"], round_tos=(rt,) * nrt,
                            policy=CompressionPolicy(round_to=rt), version=3, step=7)
    jp = jfab.pack_weight_parcel(s["jstorage0"], spec_tree=s["jspec"], round_tos=(rt,) * nrt,
                                 policy=JPolicy(round_to=rt), version=3, step=7)
    assert tp.entries == jp.entries
    assert (tp.version, tp.step, tp.residuals) == (jp.version, jp.step, jp.residuals)
    assert tp.residuals == (rt == 4)
    assert tp.nbytes == manifest_bytes(tp.manifest_meta())["total"] == \
        j_manifest_bytes(jp.manifest_meta())["total"] == train_checkpoint_bytes(
            s["tstorage0"], spec_tree=s["tspec"], round_tos=(rt,) * nrt,
            residuals=tp.residuals)["total"]
    t_out = unpack_weight_parcel(dataclasses.replace(tp, entries=jp.entries), s["tstorage0"])
    j_out = dict(leaf_entries(_np(jfab.unpack_weight_parcel(
        dataclasses.replace(jp, entries=tp.entries), s["jstorage0"]))))
    for path, t in leaf_entries(t_out):
        np.testing.assert_array_equal(t.numpy(), j_out[path])
    if rt == 4:
        for (_, a), (_, b) in zip(leaf_entries(t_out), leaf_entries(s["tstorage0"])):
            assert torch.equal(a, b)


def test_weight_parcel_structure_mismatch_raises(setup):
    s = setup
    nrt = s["tcfg"].num_groups + 1
    parcel = pack_weight_parcel(s["tstorage0"], spec_tree=s["tspec"], round_tos=(2,) * nrt,
                                policy=CompressionPolicy(round_to=2), version=0)
    with pytest.raises(FabricError, match="leaves"):
        unpack_weight_parcel(dataclasses.replace(parcel, entries=parcel.entries[:-1]),
                             s["tstorage0"])
    wire, res, info = parcel.entries[0]
    bad = dataclasses.replace(parcel, entries=((wire, res, {**info, "path": "nope"}),
                                               *parcel.entries[1:]))
    with pytest.raises(FabricError, match="structure mismatch"):
        unpack_weight_parcel(bad, s["tstorage0"])
    bad = dataclasses.replace(parcel, entries=((wire, res, {**info, "shape": [1]}),
                                               *parcel.entries[1:]))
    with pytest.raises(FabricError, match="shape mismatch"):
        unpack_weight_parcel(bad, s["tstorage0"])


def test_publisher_versions_and_save_dir(setup, tmp_path):
    """Versions count up; ``save_dir`` writes the sharded checkpoint whose
    manifest holds the parcel's entries and bytes."""
    s = setup
    pub = WeightPublisher(s["tcfg"], s["tspec"], plan=s["tplan"])
    p0 = pub.publish(s["tstorage0"], save_dir=str(tmp_path / "v0"))
    p1 = pub.publish(s["tstorage1"], step=4)
    assert (p0.version, p1.version, p1.step) == (0, 1, 4)
    meta = read_meta(str(tmp_path / "v0"))
    assert manifest_bytes(meta)["total"] == p0.nbytes
    assert not meta["residuals"]
    for e, (_, _, info) in zip(meta["trees"]["storage"], p0.entries):
        assert {k: e[k] for k in info} == info


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------


def _engine(s, **kw):
    kw = {"max_slots": SLOTS, "cache_capacity": CAP, "paged": True, "page_size": PAGE, **kw}
    return teng.ServeEngine(s["tcfg"], s["tmesh"], None, s["tspec"], kw.pop("storage",
                            s["tstorage0"]), plan=kw.pop("plan", s["tplan"]), **kw)


def _worker(s, name="w0", page_size=PAGE, plan=None):
    return PrefillWorker(name, s["tcfg"], s["tmesh"], None, s["tspec"],
                         plan=plan or s["tplan"], cache_capacity=CAP, page_size=page_size)


def test_check_fleet_arch_rejects_non_fleet_families():
    """The families the reference refuses are refused with the port's typed
    error: the reference's configs, and the port's own MoE, recurrent, audio and vision
    configs."""
    for name in ("hubert-xlarge", "mixtral-8x7b", "llama-3.2-vision-90b", "xlstm-1.3b"):
        with pytest.raises(ReplicaError):
            check_fleet_arch(j_reduced(j_get_config(name)))
    for name, match in (("mixtral-8x7b", "MoE"), ("arctic-480b", "MoE"), ("xlstm-1.3b", "MoE"),
                        ("recurrentgemma-9b", "MoE"), ("hubert-xlarge", "encoder-only"),
                        ("llama-3.2-vision-90b", "token payloads only")):
        with pytest.raises(ReplicaError, match=match):
            check_fleet_arch(reduced(get_config(name)))
    check_fleet_arch(reduced(get_config("qwen3-1.7b")))
    with pytest.raises(ReplicaError, match="sliding"):
        check_fleet_arch(dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                                             sliding_window=16))


def test_replica_requires_paged_engine(setup):
    with pytest.raises(ReplicaError):
        DecodeReplica("r0", _engine(setup, paged=False))


def test_router_constructor_validation(setup):
    s = setup
    replica = DecodeReplica("r0", _engine(s))
    with pytest.raises(RouterError):
        FleetRouter([], [_worker(s)])
    with pytest.raises(RouterError):
        FleetRouter([replica], [])
    with pytest.raises(RouterError):
        FleetRouter([replica], [_worker(s, "r0")])  # name collision
    with pytest.raises(RouterError):
        FleetRouter([replica], [_worker(s, "w1", page_size=PAGE // 2)])
    with pytest.raises(RouterError):
        FleetRouter([replica, DecodeReplica("r1", _engine(s, max_slots=3))], [_worker(s)])


def test_router_lifecycle_errors(setup):
    s = setup
    router = FleetRouter([DecodeReplica("r0", _engine(s))], [_worker(s)])
    req = _requests(s["tcfg"].vocab_size, Request)[0]
    with pytest.raises(RouterError):  # submit before any publish
        router.submit(req)
    with pytest.raises(RouterError):  # join before any publish
        router.add_replica(DecodeReplica("r1", _engine(s)))
    p0 = WeightPublisher(s["tcfg"], s["tspec"], plan=s["tplan"]).publish(s["tstorage0"])
    router.publish(p0)
    with pytest.raises(RouterError):  # versions must grow
        router.publish(p0)
    router.submit(req)
    with pytest.raises(RouterError):  # duplicate rid
        router.submit(req)
    with pytest.raises(RouterError):  # cannot drain the last replica
        router.remove_replica("r0")
    with pytest.raises(RouterError):
        router.remove_replica("nope")
    with pytest.raises(RouterError):  # a join needs a distinct name
        router.add_replica(DecodeReplica("r0", _engine(s)))
    with pytest.raises(RouterError):  # and the fleet's geometry
        router.add_replica(DecodeReplica("r9", _engine(s, cache_capacity=CAP + PAGE)))
    with pytest.raises(ValueError):  # the engine's own geometry check at submit
        router.submit(Request(rid=9, prompt_ids=(1,) * CAP, max_new=4))
    with pytest.raises(RouterError, match="max_ticks"):
        router.run([], max_ticks=0)


def test_worker_n_hits_range_and_capacity(setup):
    s = setup
    worker = _worker(s)
    with pytest.raises(ReplicaError):  # one whole page only
        worker.prefill(s["tstorage0"], Request(rid=0, prompt_ids=(1,) * 12, max_new=4), n_hits=2)
    with pytest.raises(ReplicaError):
        worker.prefill(s["tstorage0"], Request(rid=1, prompt_ids=(1,) * 24, max_new=8))
    with pytest.raises(OverflowError):  # a seed past uint32, before the prefill
        worker.prefill(s["tstorage0"], Request(rid=2, prompt_ids=(1,) * 8, max_new=2,
                                               sampling=SamplingParams(temperature=1.0,
                                                                       seed=2**32)))
    assert worker.step_log == []


def test_install_refuses_busy_replica_and_admit_pages_checks(setup):
    s = setup
    replica = DecodeReplica("r0", _engine(s))
    req = _requests(s["tcfg"].vocab_size, Request)[0]
    pages, first = _worker(s).prefill(s["tstorage0"], req)
    parcel = pack_kv_pages(pages, s["tplan"].kv_migration_policy(),
                           meta={"rid": req.rid, "n_hits": 0, "first": first})
    with pytest.raises(teng.AllocatorError):  # a parcel that skipped pages not resident
        replica.engine.admit_pages(req, unpack_kv_pages(parcel), n_hits=1, first_tok=first)
    bad = unpack_kv_pages(parcel)
    bad[0]["p0"]["k"] = bad[0]["p0"]["k"][:, :1]
    with pytest.raises(ValueError, match="pool takes"):  # pages of another geometry
        DecodeReplica("r1", _engine(s)).engine.admit_pages(req, bad, n_hits=0, first_tok=first)
    replica.admit_parcel(req, parcel)
    with pytest.raises(ReplicaError):
        replica.install(s["tstorage0"], 1)
    while replica.engine.has_work or replica.engine.pending_record:
        replica.tick()
    assert list(replica.engine.take_completed()) == [req.rid]
    replica.engine.finish()
    with pytest.raises(ValueError, match="paged"):
        _engine(s, paged=False).admit_pages(req, pages, n_hits=0, first_tok=first)


def test_fleet_on_a_mesh_raises_naming_10b(setup):
    """The two calls that raised ``NotImplementedError`` naming ROADMAP item
    10b before the fleet ran on a mesh (a ``PrefillWorker`` at tp 2 and
    ``launch.fleet --mesh 1x2``; the name is kept from then) now run:
    the launcher at 1×2 builds its workers and replicas on the mesh and
    gives the one-device launcher's streams. The workers' global pages on
    both ranks are held in ``tests/test_torch_fleet_mesh.py``."""
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--prompt-lens", "8,6", "--gen", "2",
            "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        got = launch.main(argv + ["--mesh", "1x2"])
        want = launch.main(argv)
    assert {rid: r.tokens for rid, r in got.items()} == {rid: r.tokens for rid, r in want.items()}


# ---------------------------------------------------------------------------
# swap_weights, admit_pages against admit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ws", [False, True], ids=["plain", "weight-stationary"])
def test_swap_weights_equals_fresh_engine(setup, ws):
    """After ``swap_weights`` an engine's streams equal a fresh engine's
    from the swapped weights and the reference's swapped engine's (a
    weight-stationary engine re-places them)."""
    s = setup
    treqs = _requests(s["tcfg"].vocab_size, Request)[:2]
    jreqs = _requests(s["jcfg"].vocab_size, jeng.Request)[:2]
    eng = _engine(s, weight_stationary=ws)
    base = eng.run(treqs)
    eng.swap_weights(s["tstorage1"])
    swapped = {rid: r.tokens for rid, r in eng.run(treqs).items()}
    fresh = {rid: r.tokens for rid, r in _engine(s, storage=s["tstorage1"],
                                                 weight_stationary=ws).run(treqs).items()}
    assert swapped == fresh != {rid: r.tokens for rid, r in base.items()}
    jeng_ = jeng.ServeEngine(s["jcfg"], s["jmesh"], None, s["jspec"], s["jstorage0"],
                             plan=s["jplan"], max_slots=SLOTS, cache_capacity=CAP, paged=True,
                             page_size=PAGE, weight_stationary=ws)
    jeng_.swap_weights(s["jstorage1"])
    assert swapped == {rid: list(r.tokens) for rid, r in jeng_.run(jreqs).items()}
    with pytest.raises(ValueError, match="engine runs on"):
        eng.swap_weights({**s["tstorage1"], "embed": s["tstorage1"]["embed"].to("meta")})


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_admit_pages_pools_equal_local_admission(setup, int8):
    """A migrated admission leaves the pools, the page table and the
    position bit-equal to a local one (shared-prefix hits included)."""
    s = setup
    plan = dataclasses.replace(s["tplan"], int8_kv=int8)
    reqs = _requests(s["tcfg"].vocab_size, Request)[:2]
    local, migr = _engine(s, plan=plan), _engine(s, plan=plan)
    worker = _worker(s, plan=plan)
    for e in (local, migr):
        e.begin_stream()
    for req in reqs:
        local.admit(req)
        ok, hits = migr.can_admit(req)
        pages, first = worker.prefill(s["tstorage0"], req, n_hits=len(hits))
        parcel = pack_kv_pages(pages, plan.kv_migration_policy())
        migr.admit_pages(req, unpack_kv_pages(parcel), n_hits=len(hits), first_tok=first)
    np.testing.assert_array_equal(local._table, migr._table)
    np.testing.assert_array_equal(local._next_tok, migr._next_tok)
    for a, b in zip(local._caches, migr._caches):
        for key in a:
            for x, y in zip(dataclasses.astuple(a[key]), dataclasses.astuple(b[key])):
                assert torch.equal(x, y)
    assert len(worker.step_log) == 2 and all(r["host_device"] for r in worker.step_log)


def test_admit_pages_with_a_draft_prefills_the_draft(setup):
    """With a draft, a migrated admission prefills the draft locally from
    the prompt staged h2d (priced in ``host_device``): the speculative
    streams equal a local admission's, and each record's ``host_device``
    is the local one's less the first id's d2h (the worker's)."""
    from repro_torch.serve.spec import DraftBundle

    s = setup
    draft = DraftBundle(s["tcfg"], s["tspec"], s["tstorage0"])
    reqs = _requests(s["tcfg"].vocab_size, Request, sampled=True, sampling_cls=SamplingParams)[:2]
    local, migr = (_engine(s, draft=draft, spec_k=2) for _ in range(2))
    worker = _worker(s)
    want = {rid: r.tokens for rid, r in local.run(reqs).items()}
    migr.begin_stream()
    wire = 0
    for req in reqs:
        hits = migr.can_admit(req)[1]  # the shared prefix page, after the first
        pages, first = worker.prefill(s["tstorage0"], req, n_hits=len(hits))
        parcel = pack_kv_pages(pages, s["tplan"].kv_migration_policy())
        wire += parcel.nbytes
        migr.admit_pages(req, unpack_kv_pages(parcel), n_hits=len(hits), first_tok=first,
                         wire_bytes=parcel.nbytes)
    while migr.has_work or migr.pending_record:
        migr.decode_tick()
    assert {rid: r.tokens for rid, r in migr.take_completed().items()} == want
    migr.finish()
    first_d2h = local.token_width  # one id, (width, 1) planes
    assert migr.step_log[0]["host_device"] == local.step_log[0]["host_device"] - 2 * first_d2h
    assert migr.step_log[0]["kv_migration"] == wire
    assert [r["host_device"] for r in migr.step_log[1:]] == \
        [r["host_device"] for r in local.step_log[1:len(migr.step_log)]]


# ---------------------------------------------------------------------------
# the benchmark's bytes, the launcher twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point", ["fp32_kv", "int8_kv"])
def test_bench_fleet_bytes(setup, point):
    """``benchmarks/run.py::fleet_bench``'s setup (2 replicas, 1 worker,
    capacity 28, six requests behind a one-page prefix, 8 tokens each, two
    publishes) gives ``BENCH_fleet.json``'s bytes."""
    import json
    import os

    with open(os.path.join(os.path.dirname(__file__), "..", "BENCH_fleet.json")) as f:
        want = json.load(f)["plans"][point]
    s = setup
    plan = dataclasses.replace(s["tplan"], int8_kv=point == "int8_kv")
    rng = np.random.default_rng(0)
    shared = tuple(int(t) for t in rng.integers(0, s["tcfg"].vocab_size, PAGE))
    reqs = [Request(rid=i, max_new=8, prompt_ids=shared + tuple(
        int(t) for t in rng.integers(0, s["tcfg"].vocab_size, tail)))
        for i, tail in enumerate((8, 4, 12, 6, 10, 5))]
    engines = [_engine(s, plan=plan) for _ in range(2)]
    pub = WeightPublisher(s["tcfg"], s["tspec"], plan=plan)
    parcel = pub.publish(s["tstorage0"])
    router = FleetRouter([DecodeReplica(f"r{i}", e) for i, e in enumerate(engines)],
                         [_worker(s, plan=plan)])
    router.publish(pub.publish(s["tstorage0"]))
    results = router.run(reqs)
    ws = router.wire_summary()
    analytic = fleet_migration_bytes(plan, s["tcfg"], page_size=PAGE,
                                     migrated_pages=ws["migrated_pages"], int8_kv=plan.int8_kv,
                                     publish_wire_bytes=parcel.nbytes,
                                     publish_installs=ws["publish_installs"])
    got = {"kv_migration_bytes": ws["kv_migration"], "migrated_pages": ws["migrated_pages"],
           "page_wire_bytes": analytic["page_wire_bytes"], "kv_wire_width": analytic["kv_width"],
           "weight_publish_bytes": ws["weight_publish"], "publish_installs": ws["publish_installs"],
           "ticks": ws["ticks"], "new_tokens": sum(len(r.tokens) for r in results.values()),
           "analytic_match": ws["kv_migration"] == analytic["kv_migration"]}
    assert got == {k: want[k] for k in got}


def _reference_launch(argv):
    out, old = io.StringIO(), sys.argv
    sys.argv = ["repro.launch.fleet", *argv]
    try:
        with contextlib.redirect_stdout(out):
            j_launch.main()
    finally:
        sys.argv = old
    return out.getvalue()


@pytest.mark.parametrize("extra", [[], ["--int8-kv"]], ids=["fp32", "int8"])
def test_launcher_twin_prints_the_reference_lines(setup, extra):
    """``launch.fleet`` prints the reference launcher's refresh, fabric,
    placement, analytic and check-static lines, and its streams from the
    same weights."""
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--replicas", "2", "--workers", "1",
            "--prompt-lens", "8,6,8,6", "--gen", "4", "--page-size", "8", "--refresh-at", "2",
            "--check-static", *extra]
    ref = _reference_launch(argv).splitlines()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(argv + ["--device", "cpu"], params=setup["tparams0"],
                    params1=setup["tparams1"])
    got = out.getvalue().splitlines()
    keep = ("tick ", "fabric", "placement", "check-static", "  req", "qwen3")
    assert [x for x in got if x.startswith(keep)] == [x for x in ref if x.startswith(keep)]
    assert any(x.startswith("fabric == fleet_migration_bytes") for x in got)
    assert any(x.startswith("check-static: 8 streams bit-exact") for x in got)


def test_launcher_exits_when_the_fabric_leaves_the_model(monkeypatch, capsys):
    """As the reference launcher, the twin exits non-zero when the measured
    fabric bytes differ from ``fleet_migration_bytes``."""
    real = launch.fleet_migration_bytes

    def off_by_one(*a, **kw):
        out = real(*a, **kw)
        return {**out, "kv_migration": out["kv_migration"] + 1}

    monkeypatch.setattr(launch, "fleet_migration_bytes", off_by_one)
    with pytest.raises(SystemExit, match="DIVERGED from the analytic model on kv_migration"):
        launch.main(["--arch", "qwen3-1.7b", "--reduced", "--prompt-lens", "8,6", "--gen", "2",
                     "--device", "cpu"])


# ---------------------------------------------------------------------------
# chip_smoke.py phase 19, rehearsed
# ---------------------------------------------------------------------------


def test_chip_smoke_fleet_phase_rehearses_on_cpu(capsys):
    """Phase 19's function at the reduced config with the plain versions
    (launch counts, memory and the kernels' checks are read on a card
    only). The streams it holds the fleet to, phase 7's static run and
    phase 15 (a)'s and (b)'s engines on the card, are made here by the
    same port calls at the reduced config."""
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as c
    from repro_torch.launch.serve import build_requests
    from repro_torch.launch.serve import setup as serve_setup

    cfg = reduced(get_config("qwen3-1.7b"))
    dev = torch.device("cpu")
    mesh_cfg, spec, storage = serve_setup(cfg, seed=0, device=dev)
    nrt = cfg.num_groups + 1
    plan = PrecisionPlan.build(nrt, round_to=2)
    plan8 = PrecisionPlan.build(nrt, round_to=2, int8_kv=True)
    requests = build_requests((32, 32, 24, 16, 12), 4, cfg.vocab_size)
    cap = 36

    def run(reqs, p, **kw):
        eng = teng.ServeEngine(cfg, mesh_cfg, None, spec, storage, plan=p, max_slots=SLOTS,
                               cache_capacity=cap, **kw)
        return {rid: r.tokens for rid, r in eng.run(reqs).items()}

    refs = {"requests": requests,
            "static": teng.generate_static(cfg, mesh_cfg, None, spec, storage, requests,
                                           plan=plan),
            "sampled": run(c.sampled_requests(requests), plan),
            "int8": run(requests, plan8, paged=True, page_size=PAGE)}
    out = c.fleet_path(torch, dev, refs, cfg=cfg, page=PAGE, shared=16, tails=(8, 12, 16))
    text = capsys.readouterr().out
    assert out["ok"] and out["parcel_bytes"] == train_checkpoint_bytes(
        storage, spec_tree=spec, round_tos=plan.round_tos, residuals=False)["total"]
    # v0 on r0 and r1, on r2 at its join, then v1 on r1 and r2
    assert out["ws"]["hops"]["weight_publish"] == 5
    for line in ("(a)+(c): 13 requests", "(c): phase 15 (a)'s 5 sampled streams equal",
                 "(b) int8: 5 streams equal", "phase 19:"):
        assert line in text, line
