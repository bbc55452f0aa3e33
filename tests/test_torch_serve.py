"""Contiguous-cache serving slice: port vs the JAX reference.

Both packages serve reduced qwen3-1.7b (2 layers, d 256, hd 64) from the
same weights: the reference's ``init_params(cfg, PRNGKey(0))`` carried
across exactly by ``repro_torch.convert.convert_lm_params``, with the
reference test's plan (``round_to=2`` weights and host_device entry) and
``compress_min_size=4096``. At hd 64 both sides prefill through
``attend_tiled``, as the reference does on the CPU.

Tolerances: logits atol 2e-5 / rtol 1e-5 (fp32 sums in another order in
XLA and PyTorch; logits are O(0.1)); token streams, byte counts, step
logs and tree shapes must be exactly equal.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.dist.spec import MeshCfg as JMesh
from repro.dist.spec import build_spec_tree as j_build_spec_tree
from repro.dist.spec import tree_to_storage as j_tree_to_storage
from repro.models.init import init_params as j_init_params
from repro.models.init import param_shapes as j_param_shapes
from repro.plan import PrecisionPlan as JPlan
from repro.roofline.analysis import serve_host_device_bytes as j_serve_bytes
from repro.serve import engine as jeng
from repro.serve import step as jstep
from repro.transport import CompressionPolicy as JPolicy
from repro.transport import hostdev as jhd
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import convert_lm_params
from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_storage
from repro_torch.models import attention as ta
from repro_torch.models.init import init_params
from repro_torch.plan import PrecisionPlan
from repro_torch.roofline.analysis import serve_host_device_bytes
from repro_torch.serve import engine as teng
from repro_torch.serve import step as tstep
from repro_torch.serve.api import Request, SamplingParams
from repro_torch.transport import CompressionPolicy
from repro_torch.transport import hostdev as thd

MIN_SIZE = 4096
SLOTS = 2
CAPACITY = 24
# (prompt length, max_new): mixed lengths, admissions between decode steps
SPEC = ((16, 5), (8, 6), (16, 3), (8, 4))
LOGIT_TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduced(j_get_config("qwen3-1.7b"))
    tcfg = reduced(get_config("qwen3-1.7b"))
    jmesh, tmesh = JMesh(tp=1, dp=1, compress_min_size=MIN_SIZE), MeshCfg(compress_min_size=MIN_SIZE)
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    jspec = j_build_spec_tree(params, metas, jmesh)
    jstorage = j_tree_to_storage(params, jspec, jmesh)
    _, tmetas = init_params(tcfg, device="meta")
    tparams = convert_lm_params(tcfg, _np_tree(params), device="cpu")
    tspec = build_spec_tree(tparams, tmetas, tmesh)
    tstorage = tree_to_storage(tparams, tspec, tmesh)
    nrt = jcfg.num_groups + 1
    jplan = JPlan(weights=(JPolicy(round_to=2),) * nrt, host_device=JPolicy(round_to=2))
    tplan = PrecisionPlan(weights=(CompressionPolicy(round_to=2),) * nrt,
                          host_device=CompressionPolicy(round_to=2))
    return dict(jcfg=jcfg, tcfg=tcfg, jmesh=jmesh, tmesh=tmesh, jspec=jspec,
                jstorage=jstorage, tspec=tspec, tstorage=tstorage, jplan=jplan,
                tplan=tplan, params=params, tparams=tparams)


def _requests(vocab, spec=SPEC, cls=Request):
    rng = np.random.default_rng(7)
    return [
        cls(rid=i, prompt_ids=tuple(int(t) for t in rng.integers(0, vocab, S)), max_new=g)
        for i, (S, g) in enumerate(spec)
    ]


@pytest.fixture(scope="module")
def reference_runs(setup):
    s = setup
    reqs = _requests(s["jcfg"].vocab_size, cls=jeng.Request)
    static = jeng.generate_static(s["jcfg"], s["jmesh"], None, s["jspec"], s["jstorage"],
                                  reqs, plan=s["jplan"])
    eng = jeng.ServeEngine(s["jcfg"], s["jmesh"], None, s["jspec"], s["jstorage"],
                           plan=s["jplan"], max_slots=SLOTS, cache_capacity=CAPACITY)
    res = eng.run(reqs)
    return {"static": static, "engine": {k: r.tokens for k, r in res.items()},
            "step_log": eng.step_log, "summary": eng.wire_summary()}


def _port_engine(s, **kw):
    return teng.ServeEngine(s["tcfg"], s["tmesh"], None, s["tspec"], s["tstorage"],
                            plan=s["tplan"], max_slots=SLOTS, cache_capacity=CAPACITY, **kw)


@pytest.fixture(scope="module")
def port_runs(setup):
    s = setup
    reqs = _requests(s["tcfg"].vocab_size)
    static = teng.generate_static(s["tcfg"], s["tmesh"], None, s["tspec"], s["tstorage"],
                                  reqs, plan=s["tplan"])
    out = {"static": static, "requests": reqs}
    for ws in (False, True):
        eng = _port_engine(s, weight_stationary=ws)
        res = eng.run(reqs)
        out[ws] = {"engine": {k: r.tokens for k, r in res.items()},
                   "step_log": eng.step_log, "summary": eng.wire_summary()}
    return out


# ---------------------------------------------------------------------------
# configs, trees, token planes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full-width"])
def test_config_and_param_tree_match_reference(full):
    jcfg, tcfg = j_get_config("qwen3-1.7b"), get_config("qwen3-1.7b")
    if not full:
        jcfg, tcfg = j_reduced(jcfg), reduced(tcfg)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tcfg.layers_per_group, tcfg.num_groups) == (jcfg.layers_per_group, jcfg.num_groups)
    assert tcfg.total_params() == jcfg.total_params()
    jshapes, jmetas = j_param_shapes(jcfg)
    tshapes, tmetas = init_params(tcfg, device="meta")
    jl = jax.tree_util.tree_leaves_with_path(jshapes)
    tl = jax.tree_util.tree_leaves_with_path(tshapes)
    assert [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in jl] == \
        [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in tl]
    assert jax.tree_util.tree_map(dataclasses.asdict, jmetas) == \
        jax.tree_util.tree_map(dataclasses.asdict, tmetas)
    if full:  # 28 layers in 4 groups of 7, ~2.03 B fp32 parameters
        assert tcfg.num_groups == 4 and tcfg.layers_per_group == 7
        assert tcfg.total_params() == 2_031_616_000  # the reference's count: no norm scales
        assert sum(x.numel() for _, x in tl) == 2_031_739_904


def test_spec_tree_matches_reference(setup):
    s = setup
    jl = jax.tree_util.tree_leaves(s["jspec"], is_leaf=lambda x: hasattr(x, "kind"))
    tl = jax.tree_util.tree_leaves(s["tspec"], is_leaf=lambda x: hasattr(x, "kind"))
    assert [(x.kind, x.logical, x.reps, x.s_loc) for x in jl] == \
        [(x.kind, x.logical, x.reps, x.s_loc) for x in tl]


def test_converted_weights_are_an_exact_copy(setup):
    jl = jax.tree_util.tree_leaves(setup["params"])
    tl = jax.tree_util.tree_leaves(setup["tparams"])
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("vocab", [2, 255, 256, 257, 512, 65_536, 65_537, 151_936])
@pytest.mark.parametrize("round_to", [1, 2, 3, 4])
def test_token_planes_and_width_match_reference(vocab, round_to):
    tpol, jpol = CompressionPolicy(round_to=round_to), JPolicy(round_to=round_to)
    w = tpol.token_wire_width(vocab)
    assert w == jpol.token_wire_width(vocab)
    assert tpol.token_host_bytes(37, vocab) == jpol.token_host_bytes(37, vocab)
    ids = np.random.default_rng(vocab).integers(0, vocab, (3, 5)).astype(np.int32)
    planes = thd.pack_tokens_host(ids, w)
    np.testing.assert_array_equal(planes, np.asarray(jhd.pack_tokens(jnp.asarray(ids), w)))
    dev = thd.pack_tokens(torch.from_numpy(ids), w).numpy()
    np.testing.assert_array_equal(dev, planes)
    np.testing.assert_array_equal(thd.unpack_tokens(torch.from_numpy(planes)).numpy(), ids)
    np.testing.assert_array_equal(thd.unpack_tokens_host(planes), ids)


def test_qwen3_vocab_stages_three_bytes_per_id():
    assert PrecisionPlan.build(5, round_to=2).host_device_policies()[0] \
        .token_wire_width(get_config("qwen3-1.7b").vocab_size) == 3


def test_plan_json_with_host_device_loads_across_packages():
    tplan = PrecisionPlan(weights=(CompressionPolicy(round_to=2),) * 3,
                          host_device=CompressionPolicy(round_to=1))
    jplan = JPlan.from_json(tplan.to_json())
    assert jplan.host_device == JPolicy(round_to=1)
    assert PrecisionPlan.from_json(jplan.to_json()) == tplan


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def test_global_cache_shapes_match_reference(setup):
    s = setup
    j = jstep.global_cache_shapes(s["jcfg"], s["jmesh"], SLOTS, CAPACITY, per_slot=True)
    t = tstep.global_cache_shapes(s["tcfg"], s["tmesh"], SLOTS, CAPACITY, per_slot=True)
    for jg, tg in zip(j, t):
        for key in jg:
            assert tuple(jg[key].k.shape) == tuple(tg[key].k.shape)
            assert tuple(jg[key].pos.shape) == tuple(tg[key].pos.shape)


def test_prefill_and_decode_logits_match_reference(setup):
    s = setup
    rng = np.random.default_rng(3)
    B, S, cap = 2, 16, 24
    toks = rng.integers(0, s["jcfg"].vocab_size, (B, S)).astype(np.int32)
    jpre = jstep.make_prefill_step(
        s["jcfg"], s["jmesh"], None, s["jspec"],
        {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}, plan=s["jplan"],
        cache_capacity=cap)
    jdec = jstep.make_decode_step(
        s["jcfg"], s["jmesh"], None, s["jspec"],
        {"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32),
         "pos": jax.ShapeDtypeStruct((), jnp.int32)}, plan=s["jplan"])
    tpre = tstep.make_prefill_step(s["tcfg"], s["tmesh"], None, s["tspec"],
                                   plan=s["tplan"], cache_capacity=cap)
    tdec = tstep.make_decode_step(s["tcfg"], s["tmesh"], None, s["tspec"], plan=s["tplan"])
    jl, jc = jpre(s["jstorage"], {"tokens": jnp.asarray(toks)})
    tl, tc = tpre(s["tstorage"], {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tc[0]["p0"].k.numpy(), np.asarray(jc[0]["p0"].k), atol=1e-5)
    for i in range(3):  # feed the reference's greedy ids to both sides
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jc = jdec(s["jstorage"], jc, {"tokens": jnp.asarray(nxt),
                                          "pos": jnp.asarray(S + i, jnp.int32)})
        tl, tc = tdec(s["tstorage"], tc, {"tokens": torch.from_numpy(nxt),
                                          "pos": torch.tensor(S + i, dtype=torch.int32)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        assert int(tc[0]["p0"].pos[0]) == int(jc[0]["p0"].pos[0]) == S + i + 1


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_engine_streams_match_reference_static_and_engine(port_runs, reference_runs):
    assert port_runs[False]["engine"] == reference_runs["static"]
    assert port_runs[False]["engine"] == reference_runs["engine"]
    assert port_runs["static"] == reference_runs["static"]


def test_port_engine_equals_port_static(port_runs):
    assert port_runs[False]["engine"] == port_runs["static"]
    assert {k: len(v) for k, v in port_runs["static"].items()} == \
        {i: g for i, (_, g) in enumerate(SPEC)}


def test_weight_stationary_gives_the_same_streams(port_runs):
    assert port_runs[True]["engine"] == port_runs[False]["engine"]
    assert port_runs[True]["step_log"] == port_runs[False]["step_log"]


def test_measured_host_device_equals_reference_model(setup, port_runs, reference_runs):
    s, run = setup, port_runs[False]
    summary = run["summary"]
    kw = dict(n_slots=SLOTS, prompt_lens=[S for S, _ in SPEC],
              decode_steps=summary["decode_steps"])
    want = j_serve_bytes(s["jplan"], s["jcfg"].vocab_size, **kw)
    assert serve_host_device_bytes(s["tplan"], s["tcfg"].vocab_size, **kw) == want
    assert summary["host_device"] == want["total"]
    assert run["step_log"] == reference_runs["step_log"]
    assert summary == reference_runs["summary"]


def test_slot_manager_audit_and_misuse():
    sm = teng.SlotManager(2)
    a, b = sm.alloc(10), sm.alloc(11)
    assert (a, b) == (0, 1)
    with pytest.raises(teng.CapacityError):
        sm.alloc(12)
    sm.release(a)
    with pytest.raises(teng.AllocatorError):
        sm.release(a)
    assert sm.alloc(13) == 0
    sm._free.append(1)  # corrupt: slot 1 both free and owned
    with pytest.raises(teng.InvariantError):
        sm.audit()


# Sampled requests, int8 KV (contiguous and paged), speculative decoding and
# sliding windows, once deferred here, are served (tests/test_torch_sampling.py,
# test_torch_int8_kv.py, test_torch_spec.py, test_torch_window.py), and since
# ROADMAP item 7.6 speculative decoding and windows on a mesh too
# (tests/test_torch_tp_spec.py): each case below that once raised on a mesh
# now holds a 1x2 run (two gloo ranks) to one device's run of the same
# weights. What still raises in their areas: the fleet's int8 page migration
# (item 10).


def _mesh_case_rank(rank):
    """The once-deferred options at 1x2 and on one device, from the port's
    seed-0 weights at tp 2, on rank ``rank``: ``{case: (mesh, one device)}``."""
    from repro_torch.dist.spec import tree_to_local
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.serve.spec import DraftBundle, build_draft

    tcfg = reduced(get_config("qwen3-1.7b"))
    plan = PrecisionPlan.build(tcfg.num_groups + 1, round_to=2)
    params, metas = init_params(tcfg, 0, device="cpu", tp=2)
    meshes = {}
    for name, mcfg in (("mesh", MeshCfg(tp=2)), ("one", MeshCfg())):
        spec = build_spec_tree(params, metas, mcfg)
        storage = tree_to_local(tree_to_storage(params, spec, mcfg), spec, mcfg, rank)
        meshes[name] = (mcfg, make_mesh_from_cfg(mcfg), spec, storage)
    reqs = _requests(tcfg.vocab_size)
    sampled = [Request(0, (1, 2, 3), 6, sampling=SamplingParams(temperature=0.7, seed=1))]
    out = {}
    for name, (mcfg, mesh, spec, storage) in meshes.items():
        def run(**kw):
            eng = teng.ServeEngine(tcfg, mcfg, mesh, spec, storage, plan=plan,
                                   max_slots=SLOTS, **{"cache_capacity": CAPACITY, **kw})
            return {rid: r.tokens for rid, r in eng.run(reqs).items()}

        self_draft = DraftBundle(tcfg, spec, storage)
        tiny = build_draft(tcfg, mcfg, "tiny", device="cpu")
        got = {
            "plain": run(),
            "paged": run(paged=True, page_size=8, draft=self_draft),
            "draft": run(draft=self_draft),
            "window": run(window=8, cache_capacity=8),
            "window-static": teng.generate_static(tcfg, mcfg, mesh, spec, storage, reqs,
                                                  plan=plan, window=8),
            "sampled": teng.generate_static(tcfg, mcfg, mesh, spec, storage, sampled,
                                            plan=plan, window=8),
            "int8_kv": run(draft=tiny),
        }
        for case, v in got.items():
            out.setdefault(case, {})[name] = v
    return out


@pytest.fixture(scope="module")
def mesh_cases():
    from repro_torch.launch.mesh import spawn_ranks

    ranks = spawn_ranks(_mesh_case_rank, 2)
    assert ranks[0] == ranks[1]  # every rank streams alike
    return ranks[0]


def _raises_paged(s, m):
    assert m["paged"]["mesh"] == m["paged"]["one"] == m["plain"]["mesh"] == m["plain"]["one"]


def _raises_draft(s, m):
    assert m["draft"]["mesh"] == m["draft"]["one"] == m["plain"]["one"]


def _raises_window(s, m):
    w = m["window"]
    assert w["mesh"] == w["one"] == m["window-static"]["mesh"] == m["window-static"]["one"]
    assert w["one"] != m["plain"]["one"]  # the window bites


def _raises_sampled(s, m):
    assert m["sampled"]["mesh"] == m["sampled"]["one"] and len(m["sampled"]["one"][0]) == 6


def _raises_sampled_static(s, m):
    from repro_torch.launch import serve as launch

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(["--arch", "qwen3-1.7b", "--reduced", "--mesh", "1x2", "--spec-decode",
                     "--temperature", "0.7", "--prompt-lens", "8,6", "--gen", "4",
                     "--check-static", "--device", "cpu"])
    assert "check-static: 2 streams equal to the static reference" in out.getvalue()
    assert "== serve_spec_decode_bytes" in out.getvalue()


def _raises_int8_kv(s, m):
    """The tiny draft built on the 1x2 mesh (``build_draft(cfg, mesh_cfg)``):
    the target's streams, as on one device."""
    assert m["int8_kv"]["mesh"] == m["int8_kv"]["one"] == m["plain"]["one"]


def _raises_int8_kv_plan(s, m):
    """The fleet's int8 migration plan loads (its ``kv_migration`` entry
    prices the pages at 2 bytes an int8 element) and serves: a paged int8
    engine's streams equal the int8 static run's."""
    plan = PrecisionPlan.from_json_dict({"weights": [{"round_to": 2}], "int8_kv": True,
                                         "kv_migration": {"round_to": 2}})
    assert plan.kv_migration_policy().kv_wire_width(1) == 2
    reqs = _requests(s["tcfg"].vocab_size)
    eng = teng.ServeEngine(s["tcfg"], s["tmesh"], None, s["tspec"], s["tstorage"], plan=plan,
                           max_slots=SLOTS, cache_capacity=CAPACITY, paged=True, page_size=8)
    got = {rid: r.tokens for rid, r in eng.run(reqs).items()}
    assert got == teng.generate_static(s["tcfg"], s["tmesh"], None, s["tspec"], s["tstorage"],
                                       reqs, plan=plan)


def _raises_mesh(s, m):
    from repro_torch.launch import serve as launch

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(["--arch", "qwen3-1.7b", "--reduced", "--mesh", "1x2", "--window", "8",
                     "--prompt-lens", "8,12", "--gen", "6", "--check-static", "--device", "cpu"])
    assert "check-static: 2 streams equal to the static reference" in out.getvalue()


def test_mesh_step_needs_the_mesh_groups(setup):
    """At tp = 2 a serve step without the mesh's process groups
    (``mesh=None``) is refused with a typed error, not run on one rank."""
    s = setup
    for make in (tstep.make_decode_step, tstep.make_place_step):
        with pytest.raises(ValueError, match="make_mesh_from_cfg"):
            make(s["tcfg"], MeshCfg(tp=2), None, s["tspec"], plan=s["tplan"])
    with pytest.raises(ValueError, match="make_mesh_from_cfg"):
        tstep.make_prefill_step(s["tcfg"], MeshCfg(tp=2), None, s["tspec"], plan=s["tplan"],
                                cache_capacity=CAPACITY)


@pytest.mark.parametrize("case", [
    _raises_paged, _raises_draft, _raises_window, _raises_sampled,
    _raises_sampled_static, _raises_int8_kv, _raises_int8_kv_plan, _raises_mesh,
], ids=lambda f: f.__name__[len("_raises_"):])
def test_deferred_options_raise(setup, mesh_cases, case):
    """Every case once raised: the fleet's int8 migration plan until the
    fleet was ported (item 10), the others on a mesh (item 7.6); each now
    runs."""
    case(setup, mesh_cases)


def test_unported_arch_and_flash_viability_on_cpu(setup):
    from repro_torch.launch import train as tlaunch_train

    # every arch is ported, and --chunks auto since the plan sweep (item 12):
    # one device has no gather to chunk
    out = tlaunch_train.main(["--arch", "qwen3-1.7b", "--reduced", "--chunks", "auto",
                              "--steps", "1", "--device", "cpu"])
    assert out["chunks"] == 1
    q = torch.zeros(1, 128, 2, 2, 128)
    k = torch.zeros(1, 128, 2, 128)
    assert not ta._flash_prefill_viable(True, None, False, 0, q, k)  # a CPU tensor


# ---------------------------------------------------------------------------
# on the card (marker ``cuda``; skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _prefill_kernel_vs_tiled(device, monkeypatch):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.models.env import Env

    cfg = ModelConfig(name="hd128", arch_type="dense", num_layers=1, d_model=256,
                      num_heads=2, num_kv_heads=1, head_dim=128, d_ff=0,
                      vocab_size=16, qk_norm=True, rope_theta=1e6)
    gen = torch.Generator(device=device).manual_seed(0)
    w = {n: torch.randn(shape, generator=gen, device=device) * 0.05 for n, shape in
         (("wq", (256, 256)), ("wk", (256, 128)), ("wv", (256, 128)), ("wo", (256, 256)))}
    w["q_norm"] = torch.ones(128, device=device)
    w["k_norm"] = torch.ones(128, device=device)
    x = torch.randn(1, 256, 256, generator=gen, device=device)
    env = Env()
    outs = []
    for viable in (True, False):
        if not viable:
            monkeypatch.setattr(ta, "_flash_prefill_viable", lambda *a: False)
        cache = ta.init_cache(1, 256, 1, 128, torch.float32, device=device)
        launches = flash_prefill.launches
        y, _ = ta.mha(x, w, cfg, env, mode="prefill", cache=cache)
        torch.cuda.synchronize()
        assert flash_prefill.launches == launches + int(viable)
        outs.append(y)
    return outs


@pytest.mark.cuda
def test_mha_prefill_kernel_branch_matches_tiled_on_card(cuda_device, monkeypatch):
    """d 256, 2 heads over 1 kv head, hd 128, S 256: the kernel branch and
    ``attend_tiled`` within 1e-5."""
    kern, tiled = _prefill_kernel_vs_tiled(cuda_device, monkeypatch)
    err = float((kern - tiled).abs().max())
    print(f"\nmha prefill kernel vs attend_tiled: max abs err {err:.3e}")
    assert err <= 1e-5


FULL_TOL = 1e-3  # logits are O(1); fp32 sums in other orders over 28 layers


def _reference_greedy(cfg, mesh, spec, storage, plan, prompt, gen):
    """The reference's static greedy path for one request, keeping each
    step's logits (``generate_static``'s loop)."""
    S = len(prompt)
    pre = jstep.make_prefill_step(cfg, mesh, None, spec,
                                  {"tokens": jax.ShapeDtypeStruct((1, S), jnp.int32)},
                                  plan=plan, cache_capacity=S + gen)
    dec = jstep.make_decode_step(cfg, mesh, None, spec,
                                 {"tokens": jax.ShapeDtypeStruct((1, 1), jnp.int32),
                                  "pos": jax.ShapeDtypeStruct((), jnp.int32)}, plan=plan)
    logits, caches = pre(storage, {"tokens": jnp.asarray([prompt], jnp.int32)})
    steps = [np.asarray(logits[0, -1, : cfg.vocab_size])]
    for i in range(gen - 1):
        tok = jnp.asarray([[int(np.argmax(steps[-1]))]], jnp.int32)
        logits, caches = dec(storage, caches, {"tokens": tok, "pos": jnp.asarray(S + i, jnp.int32)})
        steps.append(np.asarray(logits[0, 0, : cfg.vocab_size]))
    return steps


@pytest.mark.cuda
def test_full_width_qwen3_on_card_matches_reference(cuda_device):
    """Full-width qwen3-1.7b (28 layers, d 2048, vocab 151,936) from the
    reference's ``init_params(cfg, PRNGKey(0))``: the port's engine on the
    card (flash kernel for the 128- and 256-token prefills, CUDA
    Bitpack/Bitunpack) against the reference on the host's CPU. Prefill
    logits within ``FULL_TOL``; greedy streams equal up to any step whose
    reference top-2 logit gap is below ``FULL_TOL``.

        PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -m cuda -s tests/test_torch_serve.py
    """
    from repro_torch.kernels.flash_prefill import flash_prefill

    jcfg, tcfg = j_get_config("qwen3-1.7b"), get_config("qwen3-1.7b")
    jmesh, tmesh = JMesh(tp=1, dp=1), MeshCfg()
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    jspec = j_build_spec_tree(params, metas, jmesh)
    nrt = jcfg.num_groups + 1
    jplan, tplan = JPlan.build(nrt, round_to=2), PrecisionPlan.build(nrt, round_to=2)
    _, tmetas = init_params(tcfg, device="meta")
    tparams = convert_lm_params(tcfg, _np_tree(params), device=cuda_device)
    tspec = build_spec_tree(tparams, tmetas, tmesh)
    gen = 8
    reqs = _requests(tcfg.vocab_size, spec=((128, gen), (256, gen)))
    ref_steps = {r.rid: _reference_greedy(jcfg, jmesh, jspec, params, jplan,
                                          r.prompt_ids, gen) for r in reqs}
    del params
    pre = tstep.make_prefill_step(tcfg, tmesh, None, tspec, plan=tplan,
                                  cache_capacity=256 + gen)
    for r in reqs:
        launches = flash_prefill.launches
        logits, _ = pre(tparams, {"tokens": torch.tensor([r.prompt_ids], device=cuda_device)})
        assert flash_prefill.launches == launches + tcfg.num_layers
        got = logits[0, -1].cpu().numpy()
        gap = float(np.abs(got - ref_steps[r.rid][0]).max())
        print(f"\nprompt {len(r.prompt_ids)}: prefill logits max abs gap {gap:.3e}")
        np.testing.assert_allclose(got, ref_steps[r.rid][0], atol=FULL_TOL, rtol=0)
    eng = teng.ServeEngine(tcfg, tmesh, None, tspec, tparams, plan=tplan,
                           max_slots=2, cache_capacity=256 + gen)
    res = eng.run(reqs)
    for r in reqs:
        want = [int(np.argmax(lg)) for lg in ref_steps[r.rid]]
        got = res[r.rid].tokens
        print(f"prompt {len(r.prompt_ids)}: port {got} reference {want}")
        for t, (a, b) in enumerate(zip(got, want)):
            if a != b:
                top2 = np.sort(ref_steps[r.rid][t])[-2:]
                print(f"  diverged at step {t}: top-2 gap {top2[1] - top2[0]:.3e}")
                assert top2[1] - top2[0] < FULL_TOL
                break


def test_serve_launcher_twin_on_cpu(capsys):
    from repro_torch.launch import serve as launch

    results = launch.main(["--arch", "qwen3-1.7b", "--reduced", "--prompt-lens", "8,6,8",
                           "--gen", "3", "--max-slots", "2", "--check-static",
                           "--weight-stationary", "--device", "cpu"])
    assert sorted(results) == [0, 1, 2] and all(len(r.tokens) == 3 for r in results.values())
    assert "check-static: 3 streams equal to the static reference" in capsys.readouterr().out


def test_serve_launcher_defaults_to_the_card():
    from repro_torch.launch import serve as launch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--arch", "qwen3-1.7b", "--reduced"])

