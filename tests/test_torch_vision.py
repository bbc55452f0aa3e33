"""llama-3.2-vision-90b (gated cross-attention every 5th layer over image
embeddings) in the port against the JAX reference at ``reduced()`` (one
5-layer pattern ``(attn, attn, attn, attn, cross)``, d 256, 16 image
tokens of width 32), on one device; the engine, speculative-decoding and
fleet refusals of both 11c archs.

Both packages start from the same weights: the reference's
``init_params(cfg, PRNGKey(0))`` with every cross gate set to a seeded
value in (0.5, 1.0) (:func:`gated`), carried across by
``repro_torch.convert.convert_lm_params``. The reference initialises the
gates to zero, and ``tanh(0) = 0`` makes a cross block add nothing, so
with its own init a broken cross path would pass; the launcher tests give
the reference's launcher the same gated weights by wrapping its
``init_params``. Image features are numpy normals from a seed.

Tolerances: last-token logits atol 2e-5 / rtol 1e-5; one SGD step's loss
within rtol 1e-5, Σw² within rtol 1e-6, each leaf's update within 1e-8
plus one ulp of its largest weight plus 2e-4 of its largest update
(``tests/test_torch_archs.py``'s bars); launcher losses rtol 2e-5. Token
streams must be equal.
"""
from __future__ import annotations

import contextlib
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
from repro_torch.fleet.errors import ReplicaError
from repro_torch.fleet.replica import check_fleet_arch
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

ARCH = "llama-3.2-vision-90b"
MIN_SIZE = 4096
B, S, LR = 2, 32, 0.05
LOGIT_TOL = dict(atol=2e-5, rtol=1e-5)
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-6
UPDATE_ATOL, UPDATE_REL = 1e-8, 2e-4
GEN = 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _paths(tree):
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def gated(params, seed: int = 3):
    """``params`` (a reference tree) with every cross gate set to a seeded
    value in (0.5, 1.0): the reference's zero gates make a cross block
    add nothing (``tanh(0) = 0``), which would hide a broken cross path."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if jax.tree_util.keystr(path).endswith("['gate']"):
            return jnp.asarray(rng.uniform(0.5, 1.0, np.shape(x)), jnp.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def _gated_init(fn):
    @functools.wraps(fn)
    def init(cfg, key, tp=1):
        params, metas = fn(cfg, key, tp=tp)
        return (gated(params) if key is not None else params), metas
    return init


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    np_params = jax.tree_util.tree_map(np.array, gated(params))
    jmesh, tmesh = JMesh(compress_min_size=MIN_SIZE), MeshCfg(compress_min_size=MIN_SIZE)
    jspec = j_build_spec_tree(params, metas, jmesh)
    _, tmetas = init_params(tcfg, device="meta")
    tspec = build_spec_tree(convert_lm_params(tcfg, np_params, device="cpu"), tmetas, tmesh)
    nrt = jcfg.num_groups + 1
    return dict(jcfg=jcfg, tcfg=tcfg, np_params=np_params, jmesh=jmesh, tmesh=tmesh,
                jspec=jspec, tspec=tspec, jplan=JPlan.build(nrt, round_to=2),
                tplan=PrecisionPlan.build(nrt, round_to=2))


def _jstorage(s):
    return j_tree_to_storage(jax.tree_util.tree_map(jnp.asarray, s["np_params"]), s["jspec"],
                             s["jmesh"])


def _tstorage(s):
    return tree_to_storage(convert_lm_params(s["tcfg"], s["np_params"], device="cpu"),
                           s["tspec"], s["tmesh"])


def _images(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (n, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)


def test_prefill_logits_match_reference():
    """Last-token logits of a 16-token prefill of two rows with the same
    tokens and different images: equal to the reference's, and the rows
    differ by far more than the tolerance (the cross path is live)."""
    s = _setup()
    rng = np.random.default_rng(3)
    tokens = np.repeat(rng.integers(0, s["jcfg"].vocab_size, (1, 16)), 2, 0).astype(np.int32)
    img = _images(s["tcfg"], 2)
    shapes = {"tokens": jax.ShapeDtypeStruct(tokens.shape, jnp.int32),
              "image_features": jax.ShapeDtypeStruct(img.shape, jnp.float32)}
    jfn = jserve.make_prefill_step(s["jcfg"], s["jmesh"], None, s["jspec"], shapes,
                                   plan=s["jplan"], cache_capacity=24)
    jl, _ = jfn(_jstorage(s), {"tokens": jnp.asarray(tokens), "image_features": jnp.asarray(img)})
    tfn = tserve.make_prefill_step(s["tcfg"], s["tmesh"], None, s["tspec"], plan=s["tplan"],
                                   cache_capacity=24)
    tl, caches = tfn(_tstorage(s), {"tokens": torch.from_numpy(tokens),
                                    "image_features": torch.from_numpy(img)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    gap = float((tl[0] - tl[1]).abs().max())
    assert gap > 100 * LOGIT_TOL["atol"], gap
    cross = caches[0][f"p{s['tcfg'].pattern.index('cross')}"]
    assert int(cross.pos[0]) == s["tcfg"].num_image_tokens


def test_train_step_matches_reference():
    """One SGD step at round_to 2 from the same weights, tokens and images:
    the loss, Σw² and every leaf's update, the gate's (non-zero) and
    ``img_proj``'s among them."""
    s = _setup()
    tokens, labels = j_batch(s["jcfg"].vocab_size, B, S, 0)
    img = _images(s["tcfg"], B, seed=4)
    shapes = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
    shapes["image_features"] = jax.ShapeDtypeStruct(img.shape, jnp.float32)
    jfn = jtrain.make_train_step(s["jcfg"], s["jmesh"], None, s["jspec"],
                                 JSGD(lr=LR, momentum=0.9, weight_decay=1e-4), shapes,
                                 plan=s["jplan"])
    jst = _jstorage(s)
    old = {k: np.array(v) for k, v in _paths(jst).items()}
    jnew, _, jmet = jfn(jst, j_init_momentum(jst), {"tokens": tokens, "labels": labels,
                                                    "image_features": jnp.asarray(img)}, LR)
    tfn = ttrain.make_train_step(s["tcfg"], s["tmesh"], None, s["tspec"],
                                 SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4),
                                 {"tokens": (B, S), "labels": (B, S),
                                  "image_features": img.shape}, plan=s["tplan"])
    tst = _tstorage(s)
    tt, tl = synthetic_lm_batch(s["tcfg"].vocab_size, B, S, 0, device="cpu")
    tnew, _, tmet = tfn(tst, init_momentum(tst), {"tokens": tt, "labels": tl,
                                                  "image_features": torch.from_numpy(img)}, LR)
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
        if k.endswith("['gate']"):
            assert np.abs(tu).max() > 0, k


def _prompts(vocab):
    """Requests 0 and 1 share their prompt (and carry different images);
    one length, so that each package runs one prefill and one decode
    shape."""
    rng = np.random.default_rng(11)
    p0 = tuple(int(t) for t in rng.integers(0, vocab, 16))
    return [p0, p0, tuple(int(t) for t in rng.integers(0, vocab, 16))]


def test_static_streams_match_reference():
    """Greedy ``generate_static`` with ``Request.image_features`` equals the
    reference's, and so does the deprecated ``image_features={rid: ...}``
    keyword (with its ``DeprecationWarning``); a request without features
    raises ``ValueError`` in both packages."""
    s = _setup()
    prompts = _prompts(s["jcfg"].vocab_size)
    img = _images(s["tcfg"], len(prompts), seed=5)
    jreqs = [jeng.Request(rid=i, prompt_ids=p, max_new=GEN, image_features=img[i])
             for i, p in enumerate(prompts)]
    want = jeng.generate_static(s["jcfg"], s["jmesh"], None, s["jspec"], _jstorage(s), jreqs,
                                plan=s["jplan"])
    tst = _tstorage(s)
    treqs = [Request(rid=i, prompt_ids=p, max_new=GEN, image_features=img[i])
             for i, p in enumerate(prompts)]
    got = teng.generate_static(s["tcfg"], s["tmesh"], None, s["tspec"], tst, treqs,
                               plan=s["tplan"])
    assert got == want and len(got) == 3
    bare = [Request(rid=i, prompt_ids=p, max_new=GEN) for i, p in enumerate(prompts)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        kw = teng.generate_static(s["tcfg"], s["tmesh"], None, s["tspec"], tst, bare,
                                  plan=s["tplan"], image_features=dict(enumerate(img)))
    assert kw == want
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    with pytest.raises(ValueError, match="needs image_features"):
        teng.generate_static(s["tcfg"], s["tmesh"], None, s["tspec"], tst, bare, plan=s["tplan"])
    with pytest.raises(ValueError, match="needs image_features"):
        jeng.generate_static(s["jcfg"], s["jmesh"], None, s["jspec"], _jstorage(s),
                             [jeng.Request(rid=0, prompt_ids=prompts[0], max_new=GEN)],
                             plan=s["jplan"])


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "hubert-xlarge"])
def test_engine_spec_and_fleet_refuse_the_11c_archs(arch):
    """The serve engine refuses image and feature archs with the
    reference's error (hubert first as encoder-only, as in the
    reference); speculative decoding and the fleet refuse both."""
    tcfg, jcfg = reduced(get_config(arch)), j_reduced(j_get_config(arch))
    params, metas = init_params(tcfg, 0, device="cpu")
    spec = build_spec_tree(params, metas, MeshCfg())
    st = tree_to_storage(params, spec, MeshCfg())
    plan = PrecisionPlan.build(tcfg.num_groups + 1, round_to=2)
    msg = "encoder-only" if not tcfg.causal else "stages token payloads only"
    with pytest.raises(ValueError, match=msg):
        teng.ServeEngine(tcfg, MeshCfg(), None, spec, st, plan=plan, max_slots=2,
                         cache_capacity=32)
    jp, jm = j_init_params(jcfg, jax.random.PRNGKey(0))
    jspec = j_build_spec_tree(jp, jm, JMesh())
    with pytest.raises(ValueError, match=msg):
        jeng.ServeEngine(jcfg, JMesh(), None, jspec, j_tree_to_storage(jp, jspec, JMesh()),
                         plan=JPlan.build(jcfg.num_groups + 1, round_to=2), max_slots=2,
                         cache_capacity=32)
    with pytest.raises(ValueError, match=msg if not tcfg.causal else "token payloads only"):
        check_spec_arch(tcfg)
    with pytest.raises(ReplicaError, match=msg if not tcfg.causal else "token payloads only"):
        check_fleet_arch(tcfg)


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


def _launcher_params(arch, monkeypatch, module):
    """The gated reference weights for the port's launcher, and the
    reference launcher's ``init_params`` wrapped to gate its own."""
    monkeypatch.setattr(module, "init_params", _gated_init(j_init_params))
    params, _ = module.init_params(j_reduced(j_get_config(arch)), jax.random.PRNGKey(0), tp=1)
    return convert_lm_params(reduced(get_config(arch)), jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")


def _streams(text):
    return re.findall(r"^  req(\d+): (\[.*\])$", text, re.M)


def test_serve_launcher_static_matches_reference(monkeypatch):
    """``launch.serve --arch llama-3.2-vision-90b --reduced --static``: the
    image features drawn as the reference's launcher draws them, the same
    streams; without ``--static`` both launchers exit, and hubert exits as
    encoder-only."""
    argv = ["--arch", ARCH, "--reduced", "--prompt-lens", "16,16,16", "--gen", "3", "--static"]
    params = _launcher_params(ARCH, monkeypatch, jlaunch_serve)
    ref = _run_reference(jlaunch_serve.main, argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch_serve.main([*argv, "--device", "cpu"], params=params)
    assert _streams(buf.getvalue()) == _streams(ref) and len(_streams(ref)) == 3
    for arch, match in ((ARCH, "--static"), ("hubert-xlarge", "encoder-only")):
        bad = ["--arch", arch, "--reduced", "--prompt-lens", "8", "--gen", "2"]
        with pytest.raises(SystemExit, match=match):
            tlaunch_serve.main([*bad, "--device", "cpu"])
        with pytest.raises(SystemExit, match=match):
            _run_reference(jlaunch_serve.main, bad)


def test_train_launcher_matches_reference(monkeypatch, tmp_path):
    """``launch.train --arch llama-3.2-vision-90b --reduced --steps 2``: the
    per-step image features drawn as the reference's launcher draws them,
    losses within rtol 2e-5 of the reference launcher's, the same AWP
    line."""
    argv = ["--arch", ARCH, "--reduced", "--mesh", "1x1", "--steps", "2", "--batch", "2",
            "--seq", "32"]
    params = _launcher_params(ARCH, monkeypatch, jlaunch_train)
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    ref = _run_reference(jlaunch_train.main, [*argv, "--losses-out", str(ref_out)])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch_train.main([*argv, "--device", "cpu", "--losses-out", str(port_out)],
                           params=params)
    want = json.loads(ref_out.read_text())["losses"]
    got = json.loads(port_out.read_text())["losses"]
    np.testing.assert_allclose(got, want, rtol=2e-5)
    awp = [ln for ln in ref.splitlines() if ln.startswith("AWP:")]
    assert awp and awp == [ln for ln in buf.getvalue().splitlines() if ln.startswith("AWP:")]
