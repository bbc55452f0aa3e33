"""The recurrent families — xlstm-1.3b (mLSTM / sLSTM, attention-free) and
recurrentgemma-9b (RG-LRU with a SwiGLU, and ``local`` MQA attention with
a 2,048-token window, a 19-layer pattern) — in the port against the JAX
reference at ``reduced()`` (4 layers, d 256: xlstm's pattern ``(mlstm,
slstm)`` twice; recurrentgemma's distinct kinds ``(rglru, local)`` twice).

Both packages start from the same weights: the reference's
``init_params(cfg, PRNGKey(0))`` carried across by
``repro_torch.convert.convert_lm_params``; batches from
``synthetic_lm_batch``, prompts from a numpy seed.

Tolerances: last-token logits atol 2e-5 / rtol 1e-5 (logits O(0.1);
fp32 sums in another order, the recurrences' ``exp`` / ``tanh`` an ulp
apart); one SGD step's loss within rtol 1e-5, Σw² within rtol 1e-6, each
leaf's update within 1e-8 plus one ulp of its largest weight plus 2e-4 of
its largest update (``tests/test_torch_archs.py``'s bars). Configs,
parameter shapes and metas, token streams and byte counts must be equal.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jlaunch_serve
import repro.launch.train as jlaunch_train
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.data.pipeline import synthetic_lm_batch as j_batch
from repro.dist.spec import MeshCfg as JMesh
from repro.dist.spec import build_spec_tree as j_build_spec_tree
from repro.dist.spec import tree_to_storage as j_tree_to_storage
from repro.models import model as jmodel
from repro.models.env import Env as JEnv
from repro.models.init import init_params as j_init_params
from repro.models.init import param_shapes as j_param_shapes
from repro.optim.sgd import SGDConfig as JSGD
from repro.optim.sgd import init_momentum as j_init_momentum
from repro.plan import PrecisionPlan as JPlan
from repro.serve import engine as jeng
from repro.serve import step as jserve
from repro.train import step as jtrain
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import convert_lm_params
from repro_torch.data.pipeline import synthetic_lm_batch
from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_storage
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.launch import train as tlaunch_train
from repro_torch.models import model as tmodel
from repro_torch.models.env import Env
from repro_torch.models.init import init_params
from repro_torch.optim.sgd import SGDConfig, init_momentum
from repro_torch.plan import PrecisionPlan
from repro_torch.serve import engine as teng
from repro_torch.serve import step as tserve
from repro_torch.serve.api import Request
from repro_torch.serve.spec import check_spec_arch
from repro_torch.train import step as ttrain

ARCHS = ("xlstm-1.3b", "recurrentgemma-9b")
MIN_SIZE = 4096
B, S, LR = 4, 32, 0.05
LOGIT_TOL = dict(atol=2e-5, rtol=1e-5)
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-6
UPDATE_ATOL, UPDATE_REL = 1e-8, 2e-4
SLOTS, GEN = 2, 5
LENS = (16, 8, 16)
CONFIG_FIELDS = (
    "arch_type", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
    "vocab_size", "qk_norm", "qkv_bias", "rope_theta", "rotary_pct", "sliding_window",
    "causal", "block_pattern", "lru_dim", "conv1d_width", "mlstm_proj_factor",
    "tie_embeddings", "norm_eps", "num_precision_groups", "scan_layers", "remat",
)
META_FIELDS = ("tp_dim", "tp_units", "compress", "grad_sync_model", "grad_sync_seq")
# init_params' own sizes (the reference's ``_param_count`` undercounts the
# mLSTM's five d x 2d matrices and the sLSTM's w_in / r / w_out)
SIZES = {("xlstm-1.3b", 48): 1_817_348_096, ("recurrentgemma-9b", 19): 6_271_070_208,
         ("recurrentgemma-9b", 38): 10_444_984_320}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _paths(tree):
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """Both packages' reduced config, weights, specs and storage (the
    reference's weights from PRNGKey(0))."""
    jcfg, tcfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    np_params = jax.tree_util.tree_map(np.array, params)
    jmesh, tmesh = JMesh(compress_min_size=MIN_SIZE), MeshCfg(compress_min_size=MIN_SIZE)
    jspec = j_build_spec_tree(params, metas, jmesh)
    _, tmetas = init_params(tcfg, device="meta")
    tparams = convert_lm_params(tcfg, np_params, device="cpu")
    tspec = build_spec_tree(tparams, tmetas, tmesh)
    nrt = jcfg.num_groups + 1
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, np_params=np_params, jmesh=jmesh,
                tmesh=tmesh, jspec=jspec, tspec=tspec, jplan=JPlan.build(nrt, round_to=2),
                tplan=PrecisionPlan.build(nrt, round_to=2))


def _jstorage(s):
    return j_tree_to_storage(jax.tree_util.tree_map(jnp.asarray, s["np_params"]), s["jspec"],
                             s["jmesh"])


def _tstorage(s):
    return tree_to_storage(convert_lm_params(s["tcfg"], s["np_params"], device="cpu"),
                           s["tspec"], s["tmesh"])


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """The registry's config, its reduced variant (the pattern branch:
    recurrentgemma's 19-long pattern shrinks to its distinct kinds, and a
    pattern overrides ``layers``), the groups and the reference's
    parameter counts equal the reference's."""
    j, t = j_get_config(arch), get_config(arch)
    for cj, ct in ((j, t), (j_reduced(j), reduced(t)), (j_reduced(j, layers=2),
                                                        reduced(t, layers=2))):
        for f in CONFIG_FIELDS:
            assert getattr(ct, f) == getattr(cj, f), (arch, f)
        assert ct.pattern == cj.pattern
        assert (ct.num_groups, ct.layers_per_group) == (cj.num_groups, cj.layers_per_group)
        assert ct.total_params() == cj.total_params()
    assert reduced(t).num_layers == 4


def test_pattern_length_check():
    """``num_layers`` must be a multiple of the block pattern (the
    reference's check): recurrentgemma-9b's smallest cut is 19 layers."""
    rg = get_config("recurrentgemma-9b")
    for n in (4, 20):
        with pytest.raises(ValueError, match="multiple of the block pattern"):
            dataclasses.replace(rg, num_layers=n)
        with pytest.raises(ValueError, match="multiple of the block pattern"):
            dataclasses.replace(j_get_config("recurrentgemma-9b"), num_layers=n)
    assert dataclasses.replace(rg, num_layers=19).num_groups == 1


@pytest.mark.parametrize("arch,layers", sorted(SIZES))
def test_full_size_parameter_counts(arch, layers):
    """The true sizes of the phase 21 cells (shapes on the meta device),
    equal to the reference's abstract ``init_params(cfg, None)``."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    shapes, _ = init_params(cfg, device="meta")
    n = sum(x.numel() for x in jax.tree_util.tree_leaves(shapes))
    assert n == SIZES[(arch, layers)]
    jshapes, _ = j_param_shapes(dataclasses.replace(j_get_config(arch), num_layers=layers))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jshapes))


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch, tp):
    """Paths, shapes and metas of ``init_params`` at tp 1 and 2: the
    mLSTM's TP-sliced ``wv`` / ``wog`` / ``w_down`` and model-synced ``wq``
    / ``wk`` / ``wi`` / ``wf``, the replicated sLSTM, the RG-LRU's
    column- and row-parallel leaves; the RG-LRU's ``lam`` equal to the
    reference's constant."""
    jcfg, tcfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    jshapes, jmetas = j_param_shapes(jcfg, tp)
    tshapes, tmetas = init_params(tcfg, device="meta", tp=tp)
    js, ts = _paths(jshapes), _paths(tshapes)
    assert js.keys() == ts.keys()
    for k in js:
        assert tuple(ts[k].shape) == tuple(js[k].shape), k
    jm = _paths(jax.tree_util.tree_map(lambda m: m, jmetas, is_leaf=lambda x: hasattr(x, "tp_dim")))
    tm_ = _paths(jax.tree_util.tree_map(lambda m: m, tmetas,
                                        is_leaf=lambda x: hasattr(x, "tp_dim")))
    assert jm.keys() == tm_.keys()
    for k in jm:
        for f in META_FIELDS:
            assert getattr(tm_[k], f) == getattr(jm[k], f), (k, f)
    tparams, _ = init_params(tcfg, 0, device="cpu", tp=tp)
    jparams, _ = j_init_params(jcfg, jax.random.PRNGKey(0), tp=tp)
    for k, v in _paths(tparams).items():
        if k.endswith("['lam']"):
            assert np.array_equal(v.numpy(), np.asarray(_paths(jparams)[k]))


def test_recurrentgemma_mqa_at_tp2():
    """recurrentgemma's one kv head at tp 2 (the first kv-head count below
    tp in the port): ``wk`` / ``wv`` keep the whole head on each rank (one
    unit, replicated), the query heads split, the cache keeps one kv head
    a rank, as the reference's ``heads_local``."""
    tcfg = reduced(get_config("recurrentgemma-9b"))
    _, tmetas = init_params(tcfg, device="meta", tp=2)
    attn = tmetas["groups"][0]["p1"]["attn"]
    d, hd = tcfg.d_model, tcfg.head_dim
    assert attn["wk"].tp_units == 1 and attn["wk"].local_shape((d, hd), 2) == (d, hd)
    assert attn["wq"].local_shape((d, 4 * hd), 2) == (d, 2 * hd)
    assert Env().heads_local(1) == 1 == JEnv().heads_local(1)
    caches = tserve.init_serve_caches(tcfg, MeshCfg(tp=2), 2, 24, per_slot=True)
    assert caches[0]["p1"].k.shape[-2] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cache_shapes_match_reference(arch):
    """A rank's slotted caches at tp 2 against the reference's global
    shapes divided along its ``cache_pspecs``' model axis: the mLSTM's
    ``C`` split on its value dim (every head kept), the RG-LRU's state on
    its channels, the sLSTM's whole, the local ring at its capacity."""
    jcfg, tcfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    jmesh = JMesh(tp=2)
    glob = jserve.global_cache_shapes(jcfg, jmesh, 2, 24, per_slot=True)
    specs = jserve.cache_pspecs(jcfg, jmesh, True, per_slot=True)
    local = tserve.init_serve_caches(tcfg, MeshCfg(tp=2), 2, 24, per_slot=True)
    for g in range(jcfg.num_groups):
        for key, node in local[g].items():
            jl = jax.tree_util.tree_leaves(glob[g][key])
            jp = jax.tree_util.tree_leaves(specs[g][key],
                                           is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            tl = tmodel.node_leaves(node) + ((node.pos,) if hasattr(node, "pos") else ())
            assert len(jl) == len(tl), key
            for a, spec, b in zip(jl, jp, tl):
                want = tuple(n // 2 if ax == "model" else n for n, ax in
                             zip(a.shape, tuple(spec) + (None,) * (len(a.shape) - len(spec))))
                assert tuple(b.shape) == want, (key, a.shape, spec, b.shape)


# ---------------------------------------------------------------------------
# forwards and one train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,chunk", [("xlstm-1.3b", 0), ("xlstm-1.3b", 8),
                                        ("recurrentgemma-9b", 0)],
                         ids=["xlstm", "xlstm-chunk8", "recurrentgemma"])
def test_prefill_logits_match_reference(arch, chunk):
    """Last-token logits of a 16-token prefill (xlstm also chunkwise, the
    plan's ``mlstm_chunk`` override in both packages)."""
    s = _setup(arch)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, s["jcfg"].vocab_size, (2, 16)).astype(np.int32)
    nrt = s["jcfg"].num_groups + 1
    ov = {"mlstm_chunk": chunk} if chunk else {}
    jfn = jserve.make_prefill_step(s["jcfg"], s["jmesh"], None, s["jspec"],
                                   {"tokens": jax.ShapeDtypeStruct(tokens.shape, jnp.int32)},
                                   plan=JPlan.build(nrt, round_to=2, env_overrides=ov),
                                   cache_capacity=24)
    jl, _ = jfn(_jstorage(s), {"tokens": jnp.asarray(tokens)})
    tfn = tserve.make_prefill_step(s["tcfg"], s["tmesh"], None, s["tspec"],
                                   plan=PrecisionPlan.build(nrt, round_to=2, env_overrides=ov),
                                   cache_capacity=24)
    tl, _ = tfn(_tstorage(s), {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One SGD step at round_to 2 from the same weights and batch: the loss,
    Σw² and every leaf's update."""
    s = _setup(arch)
    tokens, labels = j_batch(s["jcfg"].vocab_size, B, S, 0)
    shapes = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
    jfn = jtrain.make_train_step(s["jcfg"], s["jmesh"], None, s["jspec"],
                                 JSGD(lr=LR, momentum=0.9, weight_decay=1e-4), shapes,
                                 plan=s["jplan"])
    jst = _jstorage(s)
    old = {k: np.array(v) for k, v in _paths(jst).items()}
    jnew, _, jmet = jfn(jst, j_init_momentum(jst), {"tokens": tokens, "labels": labels}, LR)
    tfn = ttrain.make_train_step(s["tcfg"], s["tmesh"], None, s["tspec"],
                                 SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4),
                                 {"tokens": (B, S), "labels": (B, S)}, plan=s["tplan"])
    tst = _tstorage(s)
    tt, tl = synthetic_lm_batch(s["tcfg"].vocab_size, B, S, 0, device="cpu")
    tnew, _, tmet = tfn(tst, init_momentum(tst), {"tokens": tt, "labels": tl}, LR)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tmet["group_norms_sq"].numpy(), np.asarray(jmet["group_norms_sq"]),
                               rtol=NORM_RTOL)
    jp, tp = _paths(jnew), _paths(tnew)
    assert jp.keys() == tp.keys()
    for k in jp:
        ju, tu = np.asarray(jp[k]) - old[k], tp[k].numpy() - old[k]
        atol = (UPDATE_ATOL + float(np.spacing(np.abs(old[k]).max()))
                + UPDATE_REL * float(np.abs(ju).max()))
        np.testing.assert_allclose(tu, ju, rtol=0, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _requests(vocab, cls, lens=LENS, gen=GEN):
    rng = np.random.default_rng(11)
    return [cls(rid=i, prompt_ids=tuple(int(t) for t in rng.integers(0, vocab, n)),
                max_new=gen) for i, n in enumerate(lens)]


@functools.lru_cache(maxsize=None)
def _static_runs(arch):
    """Both packages' greedy ``generate_static`` of the requests."""
    s = _setup(arch)
    jreqs = _requests(s["jcfg"].vocab_size, jeng.Request)
    treqs = _requests(s["tcfg"].vocab_size, Request)
    return (jeng.generate_static(s["jcfg"], s["jmesh"], None, s["jspec"], _jstorage(s), jreqs,
                                 plan=s["jplan"]),
            teng.generate_static(s["tcfg"], s["tmesh"], None, s["tspec"], _tstorage(s), treqs,
                                 plan=s["tplan"]))


@functools.lru_cache(maxsize=None)
def _serve_runs(arch, paged):
    """The reference's and the port's engine runs of the requests, beside
    their static runs (xlstm's paged engine: page pools for no block)."""
    s = _setup(arch)
    cap = max(LENS) + GEN
    kw = dict(paged=True, page_size=8) if paged else {}
    jstatic, tstatic = _static_runs(arch)
    jreqs = _requests(s["jcfg"].vocab_size, jeng.Request)
    jengine = jeng.ServeEngine(s["jcfg"], s["jmesh"], None, s["jspec"], _jstorage(s),
                               plan=s["jplan"], max_slots=SLOTS, cache_capacity=cap, **kw)
    jres = jengine.run(jreqs)
    treqs = _requests(s["tcfg"].vocab_size, Request)
    tst = _tstorage(s)
    tengine = teng.ServeEngine(s["tcfg"], s["tmesh"], None, s["tspec"], tst, plan=s["tplan"],
                               max_slots=SLOTS, cache_capacity=cap, **kw)
    tres = tengine.run(treqs)
    return {"jstatic": jstatic, "jengine": {k: r.tokens for k, r in jres.items()},
            "jsummary": jengine.wire_summary(), "jengine_obj": jengine, "tstatic": tstatic,
            "tengine": {k: r.tokens for k, r in tres.items()},
            "tsummary": tengine.wire_summary(), "engine": tengine}


@pytest.mark.parametrize("arch,paged", [("xlstm-1.3b", False), ("xlstm-1.3b", True),
                                        ("recurrentgemma-9b", False)],
                         ids=["xlstm", "xlstm-paged", "recurrentgemma"])
def test_engine_streams_match_reference(arch, paged):
    """The port's engine equals its static run and the reference's engine
    and ``generate_static`` (greedy); the wire summaries agree."""
    r = _serve_runs(arch, paged)
    assert r["tengine"] == r["tstatic"] == r["jengine"] == r["jstatic"]
    for k in ("host_device", "steps", "decode_steps", "admissions", "prefill_hits",
              "prefill_misses"):
        assert r["tsummary"].get(k) == r["jsummary"].get(k), k


def test_paged_xlstm_has_no_pools_and_pads_nothing():
    """The paged engine on an attention-free pattern, as the reference's:
    every node keeps its slotted state (no page pool, 0 B a page), no
    prompt is padded to a page bucket; recurrentgemma's ``local`` blocks
    have no paged layout (``ValueError`` in both packages)."""
    r = _serve_runs("xlstm-1.3b", True)
    eng = r["engine"]
    assert not eng._bucket and eng._page_bytes == 0
    assert all(isinstance(n, tmodel.RECURRENT_STATES) for g in eng._caches for n in g.values())
    assert not r["jengine_obj"]._bucket
    tcfg, jcfg = reduced(get_config("recurrentgemma-9b")), j_reduced(j_get_config(
        "recurrentgemma-9b"))
    with pytest.raises(ValueError, match="paged layout"):
        tmodel.init_paged_caches(dataclasses.replace(tcfg, sliding_window=None), Env(), 2, 4, 8,
                                 torch.float32)
    with pytest.raises(ValueError, match="paged layout"):
        jmodel.init_paged_caches(dataclasses.replace(jcfg, sliding_window=None), JEnv(), 2, 4, 8,
                                 jnp.float32)


def test_speculative_decoding_refuses_recurrent_archs():
    for arch in ARCHS:
        with pytest.raises(ValueError, match="pure-attention"):
            check_spec_arch(reduced(get_config(arch)))


# ---------------------------------------------------------------------------
# the launchers against the reference launchers
# ---------------------------------------------------------------------------


def _run_reference(main, argv):
    old, buf = sys.argv, io.StringIO()
    sys.argv = ["reference", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            main()
    finally:
        sys.argv = old
    return buf.getvalue()


def _launcher_params(arch):
    params, _ = j_init_params(j_reduced(j_get_config(arch)), jax.random.PRNGKey(0), tp=1)
    return convert_lm_params(reduced(get_config(arch)), jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")


def _streams(text):
    return re.findall(r"^  req(\d+): (\[.*\])$", text, re.M)


# each arch goes through one launcher: the engine and the train step behind
# them are held to the reference above, and tests/test_torch_archs.py runs
# both launchers (``--check-static`` included) on the other families


def test_serve_launcher_matches_reference():
    """``launch.serve --arch xlstm-1.3b --reduced``: the port's streams
    equal the reference launcher's."""
    argv = ["--arch", "xlstm-1.3b", "--reduced", "--prompt-lens", "16,8,16,8", "--gen", "3",
            "--max-slots", "2"]
    ref = _run_reference(jlaunch_serve.main, argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch_serve.main([*argv, "--device", "cpu"], params=_launcher_params("xlstm-1.3b"))
    port = buf.getvalue()
    assert _streams(port) == _streams(ref) and len(_streams(port)) == 4


def test_train_launcher_matches_reference(tmp_path):
    """``launch.train --arch recurrentgemma-9b --reduced --steps 3``: losses
    within rtol 2e-5 of the reference launcher's, the same AWP line."""
    arch = "recurrentgemma-9b"
    argv = ["--arch", arch, "--reduced", "--mesh", "1x1", "--steps", "3", "--batch", "4",
            "--seq", "32"]
    ref_out = tmp_path / "ref.json"
    ref = _run_reference(jlaunch_train.main, [*argv, "--losses-out", str(ref_out)])
    port_out = tmp_path / "port.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch_train.main([*argv, "--device", "cpu", "--losses-out", str(port_out)],
                           params=_launcher_params(arch))
    want = json.loads(ref_out.read_text())["losses"]
    got = json.loads(port_out.read_text())["losses"]
    np.testing.assert_allclose(got, want, rtol=2e-5)
    awp = [ln for ln in ref.splitlines() if ln.startswith("AWP:")]
    assert awp and awp == [ln for ln in buf.getvalue().splitlines() if ln.startswith("AWP:")]
