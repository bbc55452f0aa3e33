"""The five attention archs of the MoE-and-variants slice — qwen3-14b,
qwen2.5-14b (QKV biases), chatglm3-6b (G 16, half rotary), mixtral-8x7b
(8 experts, top-2, sliding window) and arctic-480b (128 experts, expert
parallel, a dense residual) — in the port against the JAX reference at
``reduced()``.

Both packages start from the same weights: the reference's
``init_params(cfg, PRNGKey(0))`` carried across by
``repro_torch.convert.convert_lm_params``, with qwen2.5's ``bq`` / ``bk``
/ ``bv`` (zeros in the reference's init) drawn from a numpy seed in both,
so that a missing or misplaced bias shows; batches from
``synthetic_lm_batch``, prompts from a numpy seed. At hd 64 both sides
attend through ``attend_tiled``, as the reference does on the CPU.

Tolerances: last-token logits atol 2e-5 / rtol 1e-5 (fp32 sums in
another order; logits are O(0.1)); one SGD step's loss (the NLL and the
MoE aux term) within rtol 1e-5, Σw² within rtol 1e-6, each leaf's weight
update within 1e-8 plus one ulp of its largest weight plus 2e-4 of its
largest update (the expert and router gradients sum fp32 products over
the routed tokens in another order, seen up to ~1e-4 of the update).
Configs, parameter shapes and metas, token streams, routing decisions
and byte counts must be equal. MoE streams are compared per request (a
batch's capacity dispatch ranks all of its tokens): the engine against
``generate_static`` run request by request, in both packages.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import re
import sys
import warnings

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
from repro.models.init import init_params as j_init_params
from repro.models.init import param_shapes as j_param_shapes
from repro.optim.sgd import SGDConfig as JSGD
from repro.optim.sgd import init_momentum as j_init_momentum
from repro.plan import PrecisionPlan as JPlan
from repro.serve import engine as jeng
from repro.serve import step as jserve
from repro.train import step as jtrain
from repro_torch.configs.registry import UNPORTED_ARCHS, get_config, reduced
from repro_torch.convert import convert_lm_params
from repro_torch.data.pipeline import synthetic_lm_batch
from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_storage
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.launch import train as tlaunch_train
from repro_torch.models.init import init_params
from repro_torch.optim.sgd import SGDConfig, init_momentum
from repro_torch.plan import PrecisionPlan
from repro_torch.serve import engine as teng
from repro_torch.serve import step as tserve
from repro_torch.serve.api import Request
from repro_torch.serve.spec import check_spec_arch
from repro_torch.train import step as ttrain

ARCHS = ("qwen3-14b", "qwen2.5-14b", "chatglm3-6b", "mixtral-8x7b", "arctic-480b")
MIN_SIZE = 4096
B, S, LR = 4, 32, 0.05
LOGIT_TOL = dict(atol=2e-5, rtol=1e-5)
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-6
UPDATE_ATOL, UPDATE_REL = 1e-8, 2e-4
BIAS_SEED, BIAS_STD = 5, 0.1
SLOTS, GEN = 2, 5
LENS = (16, 8, 16, 12)
CONFIG_FIELDS = (
    "arch_type", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
    "vocab_size", "qk_norm", "qkv_bias", "rope_theta", "rotary_pct", "sliding_window",
    "causal", "num_experts", "top_k", "capacity_factor", "moe_dense_ff", "moe_impl",
    "tie_embeddings", "norm_eps", "num_precision_groups", "scan_layers", "remat",
)
META_FIELDS = ("tp_dim", "tp_units", "compress", "grad_sync_model", "grad_sync_seq")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _paths(tree):
    """{path: leaf} of a reference or port tree (dicts and lists)."""
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """Both packages' reduced config, weights, specs and storage (the
    reference's weights from PRNGKey(0); qwen2.5's biases from a seed)."""
    jcfg, tcfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    np_params = jax.tree_util.tree_map(np.array, params)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(BIAS_SEED)
        for g in np_params["groups"]:
            for k in ("bq", "bk", "bv"):
                a = g["p0"]["attn"][k]
                a[...] = rng.normal(0, BIAS_STD, a.shape).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
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
    """Fresh reference storage (the reference's train step donates its)."""
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
    """The registry's config at its widths, its reduced variant and the
    parameter counts equal the reference's."""
    j, t = j_get_config(arch), get_config(arch)
    for cj, ct in ((j, t), (j_reduced(j), reduced(t))):
        for f in CONFIG_FIELDS:
            assert getattr(ct, f) == getattr(cj, f), (arch, f)
        assert (ct.num_groups, ct.layers_per_group) == (cj.num_groups, cj.layers_per_group)
        assert ct.total_params() == cj.total_params()
        assert ct.active_params() == cj.active_params()


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llama-3.2-vision-90b"])
def test_unported_archs_raise_naming_their_item(arch):
    """The two archs that raised naming ROADMAP item 11c until it was
    ported: no arch is left unported, and the port's config of each equals
    the reference's field for field."""
    assert not UNPORTED_ARCHS
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch, tp):
    """Paths, shapes and metas of ``init_params`` at tp 1 and 2 (the
    experts' tp slices of mixtral, arctic's ``ep`` metas and dense
    residual, the router's compression rule, the biases' metas)."""
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
    if jcfg.num_experts:
        assert "['router']" in " ".join(js)
    if jcfg.qkv_bias:
        assert any(k.endswith("['bq']") for k in js)


def test_seeded_weights_have_the_mixers_and_biases():
    """The port's own init at a seed: zero biases (as the reference's),
    ones for norms, expert leaves drawn."""
    params, _ = init_params(reduced(get_config("qwen2.5-14b")), 0, device="cpu")
    attn = params["groups"][0]["p0"]["attn"]
    assert all(not attn[k].any() for k in ("bq", "bk", "bv"))
    params, _ = init_params(reduced(get_config("arctic-480b")), 0, device="cpu")
    mix = params["groups"][0]["p0"]["mix"]
    assert mix["w_gate"].shape == (1, 4, 256, 512) and mix["dense_gate"].shape == (1, 256, 256)
    assert float(mix["w_gate"].std()) > 0.01 and bool((mix["ln"] == 1).all())


# ---------------------------------------------------------------------------
# forwards and one train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(arch):
    s = _setup(arch)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, s["jcfg"].vocab_size, (2, 16)).astype(np.int32)
    jfn = jserve.make_prefill_step(s["jcfg"], s["jmesh"], None, s["jspec"],
                                   {"tokens": jax.ShapeDtypeStruct(tokens.shape, jnp.int32)},
                                   plan=s["jplan"], cache_capacity=24)
    jl, _ = jfn(_jstorage(s), {"tokens": jnp.asarray(tokens)})
    tfn = tserve.make_prefill_step(s["tcfg"], s["tmesh"], None, s["tspec"], plan=s["tplan"],
                                   cache_capacity=24)
    tl, _ = tfn(_tstorage(s), {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One SGD step at round_to 2 from the same weights and batch: the loss
    (the MoE aux term included), Σw² and every leaf's update."""
    s = _setup(arch)
    nrt = s["jcfg"].num_groups + 1
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


def test_moe_loss_carries_the_aux_term():
    """The step's loss is the NLL over the tokens plus ``AUX_COEF · aux /
    num_layers``, with the step's ``aux`` metric the layers' summed aux
    (one device, one micro-batch) equal to the forward's; the aux of a
    top-2 router is near 1 a layer, so the term is ~1e-2. The NLL from
    ``forward_loss`` at the step's weight policies; atol 2e-6 (one fp32
    rounding of a loss near 10)."""
    from repro_torch.models import model as tmodel

    s = _setup("mixtral-8x7b")
    tt, tl = synthetic_lm_batch(s["tcfg"].vocab_size, B, S, 0, device="cpu")
    fn = ttrain.make_train_step(s["tcfg"], s["tmesh"], None, s["tspec"], SGDConfig(lr=0.0),
                                {"tokens": (B, S), "labels": (B, S)}, plan=s["tplan"])
    st = _tstorage(s)
    met = fn(st, init_momentum(st), {"tokens": tt, "labels": tl}, 0.0)[2]
    tp = convert_lm_params(s["tcfg"], s["np_params"], device="cpu")
    mat_group, mat_top = ttrain.make_mat_fns(s["tspec"], s["tmesh"], s["tplan"].weight_policies())
    nll, fmet = tmodel.forward_loss(tp, {"tokens": tt, "labels": tl}, s["tcfg"],
                                    s["tplan"].make_env(s["tmesh"]), mat_group=mat_group,
                                    mat_top=mat_top(tp))
    np.testing.assert_allclose(float(met["aux"]), float(fmet["aux"]), rtol=1e-6)
    term = ttrain.AUX_COEF * float(met["aux"]) / s["tcfg"].num_layers
    np.testing.assert_allclose(float(met["loss"]) - float(nll) / (B * S), term, rtol=0,
                               atol=2e-6)
    assert 0.5e-2 < term < 2e-2, term


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _requests(vocab, cls, lens=LENS, gen=GEN, prefix=()):
    rng = np.random.default_rng(11)
    return [cls(rid=i, prompt_ids=tuple(prefix) + tuple(int(t) for t in
                                                         rng.integers(0, vocab, n)),
                max_new=gen) for i, n in enumerate(lens)]


def _static(gen_fn, cfg, *args, requests, per_request, **kw):
    if not per_request:
        return gen_fn(cfg, *args, requests, **kw)
    out = {}
    for r in requests:
        out.update(gen_fn(cfg, *args, [r], **kw))
    return out


@functools.lru_cache(maxsize=None)
def _serve_runs(arch, paged):
    """The reference's and the port's static run (request by request for a
    MoE model) and engine run of the same requests."""
    s = _setup(arch)
    moe = bool(s["jcfg"].num_experts)
    cap = max(LENS) + GEN
    kw = dict(paged=paged, page_size=8) if paged else {}
    jreqs = _requests(s["jcfg"].vocab_size, jeng.Request)
    jst = _jstorage(s)
    jstatic = _static(jeng.generate_static, s["jcfg"], s["jmesh"], None, s["jspec"], jst,
                      requests=jreqs, per_request=moe, plan=s["jplan"])
    jengine = jeng.ServeEngine(s["jcfg"], s["jmesh"], None, s["jspec"], jst, plan=s["jplan"],
                               max_slots=SLOTS, cache_capacity=cap, **kw)
    jres = jengine.run(jreqs)
    treqs = _requests(s["tcfg"].vocab_size, Request)
    tst = _tstorage(s)
    tstatic = _static(teng.generate_static, s["tcfg"], s["tmesh"], None, s["tspec"], tst,
                      requests=treqs, per_request=moe, plan=s["tplan"])
    tengine = teng.ServeEngine(s["tcfg"], s["tmesh"], None, s["tspec"], tst, plan=s["tplan"],
                               max_slots=SLOTS, cache_capacity=cap, **kw)
    tres = tengine.run(treqs)
    return {"jstatic": jstatic, "jengine": {k: r.tokens for k, r in jres.items()},
            "jsummary": jengine.wire_summary(), "tstatic": tstatic,
            "tengine": {k: r.tokens for k, r in tres.items()},
            "tsummary": tengine.wire_summary(), "engine": tengine}


@pytest.mark.parametrize("arch,paged", [("chatglm3-6b", True), ("qwen2.5-14b", True),
                                        ("qwen2.5-14b", False), ("mixtral-8x7b", False),
                                        ("arctic-480b", True)],
                         ids=["chatglm3-paged", "qwen2.5-paged", "qwen2.5", "mixtral",
                              "arctic-paged"])
def test_engine_streams_match_reference(arch, paged):
    """The port's engine equals its static run (per request for MoE) and
    the reference's engine and static run; the wire summaries agree."""
    r = _serve_runs(arch, paged)
    assert r["tengine"] == r["tstatic"] == r["jengine"] == r["jstatic"]
    for k in ("host_device", "steps", "decode_steps", "admissions", "prefill_hits",
              "prefill_misses"):
        assert r["tsummary"].get(k) == r["jsummary"].get(k), k


def test_moe_paged_engine_neither_pads_nor_shares_prefixes():
    """A paged arctic engine (no window, so paged serving is open to it)
    admits every prompt at its own length — the capacity dispatch would
    route pad tokens — and interns no prefix page, as the reference's: a
    shared 16-token prefix finds no resident page, every length is a
    prefill first seen, and the streams equal the per-request static run."""
    s = _setup("arctic-480b")
    reqs = _requests(s["tcfg"].vocab_size, Request, lens=(5, 9, 5), gen=3, prefix=range(16))
    eng = teng.ServeEngine(s["tcfg"], s["tmesh"], None, s["tspec"], _tstorage(s),
                           plan=s["tplan"], max_slots=3, cache_capacity=40, paged=True,
                           page_size=8)
    assert not eng.share_prefix and not eng._bucket
    prefills = []
    real = eng._prefill_for
    eng._prefill_for = lambda n: prefills.append(n) or real(n)
    res = eng.run(reqs)
    assert prefills == [21, 25, 21] and not eng._intern
    assert eng.wire_summary()["prefill_misses"] == 2
    static = _static(teng.generate_static, s["tcfg"], s["tmesh"], None, s["tspec"],
                     _tstorage(s), requests=reqs, per_request=True, plan=s["tplan"])
    assert {k: v.tokens for k, v in res.items()} == static
    dense = _setup("qwen2.5-14b")
    eng = teng.ServeEngine(dense["tcfg"], dense["tmesh"], None, dense["tspec"], _tstorage(dense),
                           plan=dense["tplan"], max_slots=3, cache_capacity=40, paged=True,
                           page_size=8)
    assert eng.share_prefix and eng._bucket  # a dense model still pads and shares


def test_speculative_decoding_refuses_moe():
    with pytest.raises(ValueError, match="MoE"):
        check_spec_arch(reduced(get_config("mixtral-8x7b")))
    with pytest.raises(ValueError, match="MoE"):
        check_spec_arch(reduced(get_config("arctic-480b")))
    check_spec_arch(reduced(get_config("qwen2.5-14b")))


@pytest.mark.parametrize("slots,warns", [(4, False), (5, True)])
def test_moe_capacity_warning(slots, warns):
    """``max_slots · top_k`` above the dispatch capacity floor of 8 warns,
    typed, as the reference's engine does."""
    s = _setup("mixtral-8x7b")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        teng.ServeEngine(s["tcfg"], s["tmesh"], None, s["tspec"], _tstorage(s), plan=s["tplan"],
                         max_slots=slots, cache_capacity=24)
    assert any(issubclass(w.category, teng.CapacityWarning) for w in seen) == warns


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
    """The reference launcher's weights (PRNGKey(0), tp 1), for the port's."""
    params, _ = j_init_params(j_reduced(j_get_config(arch)), jax.random.PRNGKey(0), tp=1)
    return convert_lm_params(reduced(get_config(arch)), jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")


def _streams(text):
    return re.findall(r"^  req(\d+): (\[.*\])$", text, re.M)


@pytest.mark.parametrize("arch,extra", [("mixtral-8x7b", []),
                                        ("arctic-480b", ["--paged", "--page-size", "8"]),
                                        ("chatglm3-6b", ["--paged", "--page-size", "8"])],
                         ids=["mixtral", "arctic-paged", "chatglm3-paged"])
def test_serve_launcher_matches_reference(arch, extra):
    """``launch.serve --arch ... --reduced --check-static``: the port's
    streams equal the reference launcher's, and a MoE arch's static run is
    made request by request in both."""
    argv = ["--arch", arch, "--reduced", "--prompt-lens", "16,12,16,8", "--gen", "4",
            "--max-slots", "2", "--check-static", *extra]
    ref = _run_reference(jlaunch_serve.main, argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch_serve.main([*argv, "--device", "cpu"], params=_launcher_params(arch))
    port = buf.getvalue()
    assert _streams(port) == _streams(ref) and len(_streams(port)) == 4
    moe = bool(get_config(arch).num_experts)
    assert ("per-request static reference" in port) == moe
    assert ("per-request static reference" in ref) == moe
    assert "check-static: 4 streams equal to the static reference" in port


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b", "qwen2.5-14b"])
def test_train_launcher_matches_reference(arch, tmp_path):
    """``launch.train --arch ... --reduced --steps 3``: losses (the aux term
    included) within rtol 2e-5 of the reference launcher's, the same AWP
    line."""
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


def test_chip_smoke_archs_phase_rehearses_on_cpu():
    """``chip_smoke.py`` phase 20 at reduced configs on the CPU (the plain
    versions; launch counts and memory are read on a card only): every
    stream check, the aux and the wire checks pass."""
    import os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    def r(name):
        return reduced(get_config(name))

    out = chip_smoke.archs_path(
        torch, torch.device("cpu"), a_cfg=r("chatglm3-6b"), b_cfg=r("qwen2.5-14b"),
        c_cfg=r("mixtral-8x7b"), d_cfg=dataclasses.replace(r("mixtral-8x7b"), remat=True),
        lens=(32, 32, 24, 16, 12), gen=4, page=8)
    assert set(out["a"]["runs"]) == {"engine", "paged engine"}
    assert set(out["c"]["runs"]) == {"engine"}
    assert len(out["d"]["aux"]) == chip_smoke.ARCH_TRAIN_STEPS and min(out["d"]["aux"]) > 0
    assert all(v == 0 for v in out["launches"].values())  # no kernel on the CPU
