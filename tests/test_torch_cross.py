"""The blocks of vision cross-attention (llama-3.2-vision-90b) and of the
audio encoder (hubert-xlarge) in the port against the JAX reference on the
CPU, at ``reduced()`` widths (d 256, 4 heads of 64; llama's 16 image
tokens of width 32, hubert's 32-wide input features), and the two archs'
configs and parameter trees.

Inputs and weights are numpy from seeds, given to both packages as they
are; the attention weights are drawn at std ``1 / sqrt(d)`` and the cross
gates at a seeded value in (0.5, 1.0), so that a cross block's output is
O(1): the reference initialises the gate to zero, and ``tanh(0) = 0`` would
let a broken cross path pass.

Tolerances (fp32; the sums run in another order): a block's output atol
2e-5 / rtol 1e-4; the image KV a cross prefill leaves in its cache atol
1e-6 / rtol 1e-5 (one matmul); the feature stub and ``img_proj`` atol
1e-6 / rtol 1e-5. Configs, shapes, metas, parameter counts and checkpoint
bytes must be equal.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import load_checkpoint as j_load_checkpoint
from repro.checkpoint.ckpt import save_checkpoint as j_save_checkpoint
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.dist.spec import MeshCfg as JMesh
from repro.dist.spec import build_spec_tree as j_build_spec_tree
from repro.dist.spec import tree_to_storage as j_tree_to_storage
from repro.models import attention as ja
from repro.models import mlp as jmlp
from repro.models import model as jmodel
from repro.models.env import Env as JEnv
from repro.models.init import init_params as j_init_params
from repro.models.init import param_shapes as j_param_shapes
from repro.optim.sgd import init_momentum as j_init_momentum
from repro.plan import PrecisionPlan as JPlan
from repro.serve import step as jserve
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs.registry import ARCHS, UNPORTED_ARCHS, get_config, reduced
from repro_torch.configs.shapes import input_specs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.convert import convert_lm_params
from repro_torch.dist.spec import REPL, MeshCfg, build_spec_tree, tree_to_storage
from repro_torch.models import attention as ta
from repro_torch.models import mlp as tmlp
from repro_torch.models import model as tmodel
from repro_torch.models.env import Env
from repro_torch.models.init import init_params
from repro_torch.optim.sgd import init_momentum
from repro_torch.plan import PrecisionPlan
from repro_torch.serve import step as tserve
from repro_torch.serve.step import make_place_step

ARCHS_11C = ("llama-3.2-vision-90b", "hubert-xlarge")
OUT_TOL = dict(atol=2e-5, rtol=1e-4)
KV_TOL = dict(atol=1e-6, rtol=1e-5)
EMBED_TOL = dict(atol=1e-6, rtol=1e-5)
CONFIG_FIELDS = (
    "arch_type", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
    "vocab_size", "qk_norm", "qkv_bias", "rope_theta", "rotary_pct", "sliding_window",
    "causal", "cross_attn_every", "num_image_tokens", "vision_dim", "block_pattern",
    "tie_embeddings", "norm_eps", "embed_is_input_stub", "num_precision_groups",
    "scan_layers", "remat",
)
META_FIELDS = ("tp_dim", "tp_units", "compress", "grad_sync_model", "grad_sync_seq")
# init_params' own sizes (finding 1-2 of the slice: the reference's
# ``_param_count`` prices a SwiGLU on every cross block, which has none,
# and three matrices for hubert's two-matrix GeLU MLP)
SIZES = {("llama-3.2-vision-90b", 5): 5_685_460_993,
         ("llama-3.2-vision-90b", 100): 73_584_254_996,
         ("hubert-xlarge", 48): 946_126_080}
B = 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _paths(tree):
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _cfgs(arch):
    return j_reduced(j_get_config(arch)), reduced(get_config(arch))


def _attn_weights(cfg, seed, *, cross):
    """One attention block's weights at std 1/sqrt(d) (numpy), a cross
    block's gate at a seeded value in (0.5, 1.0)."""
    rng = np.random.default_rng(seed)
    d, hd, H, Kv = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    s = d ** -0.5
    w = {"wq": rng.normal(0, s, (d, H * hd)), "wk": rng.normal(0, s, (d, Kv * hd)),
         "wv": rng.normal(0, s, (d, Kv * hd)), "wo": rng.normal(0, s, (H * hd, d)),
         "ln": np.ones(d)}
    if cross:
        w["gate"] = np.asarray(rng.uniform(0.5, 1.0))
    return {k: np.asarray(v, np.float32) for k, v in w.items()}


def _both(w):
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v.copy()) for k, v in w.items()})


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk", [(32, 32), (24, 12)], ids=["chunk32", "chunk12"])
def test_cross_prefill_and_decode_match_reference(S, chunk):
    """A cross block's prefill over 16 image tokens (a chunk above 16, the
    image KV padded to 32; a chunk of 12 that does not divide 16, padded
    to 24), the image KV it leaves in the cache, then one decode step
    through ``_cross_decode`` over that cache."""
    jcfg, tcfg = _cfgs("llama-3.2-vision-90b")
    N, d = tcfg.num_image_tokens, tcfg.d_model
    jw, tw = _both(_attn_weights(tcfg, 1, cross=True))
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    img = rng.normal(0, 1, (B, N, d)).astype(np.float32)
    xd = rng.normal(0, 1, (B, 1, d)).astype(np.float32)
    jy, jc = ja.mha(jnp.asarray(x), jw, jcfg, JEnv(attn_chunk=chunk), mode="prefill",
                    kv_ext=jnp.asarray(img), is_cross=True)
    cache = ta.init_cache(B, N, tcfg.num_kv_heads, tcfg.head_dim, torch.float32)
    ty, tc = ta.mha(torch.from_numpy(x), tw, tcfg, Env(attn_chunk=chunk), mode="prefill",
                    cache=cache, kv_ext=torch.from_numpy(img), is_cross=True)
    assert tc is cache and int(tc.pos) == N == int(jc.pos)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **OUT_TOL)
    assert float(np.abs(np.asarray(jy)).max()) > 0.1  # the gated cross path is live
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **KV_TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **KV_TOL)
    jyd, _ = ja.mha(jnp.asarray(xd), jw, jcfg, JEnv(), mode="decode", cache=jc, is_cross=True,
                    pos_offset=jnp.asarray(S, jnp.int32))
    tyd, tcd = ta.mha(torch.from_numpy(xd), tw, tcfg, Env(), mode="decode", cache=tc,
                      is_cross=True, pos_offset=torch.tensor(S, dtype=torch.int32))
    np.testing.assert_allclose(tyd.numpy(), np.asarray(jyd), **OUT_TOL)
    assert int(tcd.pos) == N  # the static image KV is not written by decode


def test_cross_cache_stays_in_the_compute_dtype_and_needs_its_source():
    """Under int8 KV a cross block's cache keeps the compute dtype (the
    reference's ``_block_cache``); a prefill without ``kv_ext`` raises."""
    _, tcfg = _cfgs("llama-3.2-vision-90b")
    caches = tmodel.init_caches(tcfg, Env(int8_kv=True), B, 40, torch.float32)
    node = caches[0][f"p{tcfg.pattern.index('cross')}"]
    assert isinstance(node, ta.KVCache) and node.k.dtype == torch.float32
    assert node.k.shape[2] == tcfg.num_image_tokens and node.pos.shape == (1,)
    assert isinstance(caches[0]["p0"], ta.QuantKVCache)
    _, tw = _both(_attn_weights(tcfg, 1, cross=True))
    with pytest.raises(ValueError, match="kv_ext"):
        ta.mha(torch.zeros(B, 8, tcfg.d_model), tw, tcfg, Env(), mode="train", is_cross=True)
    with pytest.raises(ValueError, match="paged layout"):
        tmodel.init_paged_caches(tcfg, Env(), B, 4, 8, torch.float32)


def test_gelu_mlp_matches_reference():
    """hubert's mixer: ``w_up``, the tanh GeLU, ``w_down``."""
    _, tcfg = _cfgs("hubert-xlarge")
    rng = np.random.default_rng(4)
    d, ff = tcfg.d_model, tcfg.d_ff
    w = {"w_up": rng.normal(0, d ** -0.5, (d, ff)), "w_down": rng.normal(0, ff ** -0.5, (ff, d))}
    jw, tw = _both({k: v.astype(np.float32) for k, v in w.items()})
    x = rng.normal(0, 1, (B, 16, d)).astype(np.float32)
    np.testing.assert_allclose(tmlp.gelu_mlp(torch.from_numpy(x), tw, Env()).numpy(),
                               np.asarray(jmlp.gelu_mlp(jnp.asarray(x), jw, JEnv())), **OUT_TOL)


@pytest.mark.parametrize("mode,chunk", [("train", 16), ("prefill", 32), ("prefill", 12)])
def test_bidirectional_attention_matches_reference(mode, chunk):
    """hubert's self-attention (``causal=False``, rotary on): train mode
    and a prefill with its cache, through ``attend_tiled`` at several
    chunks (every q chunk sees every key)."""
    jcfg, tcfg = _cfgs("hubert-xlarge")
    S = 24 if chunk == 12 else 32
    jw, tw = _both(_attn_weights(tcfg, 5, cross=False))
    x = np.random.default_rng(6).normal(0, 1, (B, S, tcfg.d_model)).astype(np.float32)
    kw = {}
    if mode == "prefill":
        kw = {"cache": ja.init_cache(B, S, tcfg.num_kv_heads, tcfg.head_dim, jnp.float32)}
    jy, _ = ja.mha(jnp.asarray(x), jw, jcfg, JEnv(attn_chunk=chunk), mode=mode, **kw)
    if mode == "prefill":
        kw = {"cache": ta.init_cache(B, S, tcfg.num_kv_heads, tcfg.head_dim, torch.float32)}
    ty, _ = ta.mha(torch.from_numpy(x), tw, tcfg, Env(attn_chunk=chunk), mode=mode, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **OUT_TOL)
    # not causal: the first position's output depends on the last token
    x2 = x.copy()
    x2[:, -1] += 1.0
    ty2, _ = ta.mha(torch.from_numpy(x2), tw, tcfg, Env(attn_chunk=chunk), mode="train")
    assert not torch.allclose(ty2[:, 0], ty[:, 0])


@pytest.mark.parametrize("arch", ARCHS_11C)
def test_feature_stub_and_image_kv_match_reference(arch):
    """``_embed`` through the input stub (hubert: ``features @ embed_in``)
    or the token lookup (llama), and ``_img_kv`` (``image_features @
    img_proj``; ``None`` for hubert)."""
    jcfg, tcfg = _cfgs(arch)
    params, _ = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert_lm_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(7)
    S = 16
    if tcfg.embed_is_input_stub:
        batch = {"features": rng.normal(0, 1, (B, S, tcfg.vision_dim)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)}
    if tcfg.num_image_tokens:
        batch["image_features"] = rng.normal(
            0, 1, (B, tcfg.num_image_tokens, tcfg.vision_dim)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jx = jmodel._embed(params, jb, jcfg, JEnv(), lambda n: params[n])
    tx = tmodel._embed(tparams, tb, tcfg, Env(), lambda n: tparams[n])
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **EMBED_TOL)
    jk = jmodel._img_kv(params, jb, jcfg, JEnv(), lambda n: params[n])
    tk = tmodel._img_kv(tparams, tb, tcfg, Env(), lambda n: tparams[n])
    assert (jk is None) == (tk is None) == (not tcfg.num_image_tokens)
    if tk is not None:
        assert tuple(tk.shape) == (B, tcfg.num_image_tokens, tcfg.d_model)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **EMBED_TOL)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS_11C)
def test_config_matches_reference(arch):
    """The config, its reduced variant (llama's one 5-layer pattern,
    16 image tokens of width 32; hubert's 2 layers and 32-wide features),
    the groups, the pattern, the reference's parameter counts, the decoder
    flags and the input stand-ins."""
    j, t = j_get_config(arch), get_config(arch)
    for cj, ct in ((j, t), (j_reduced(j), reduced(t))):
        for f in CONFIG_FIELDS:
            assert getattr(ct, f) == getattr(cj, f), (arch, f)
        assert ct.pattern == cj.pattern
        assert (ct.num_groups, ct.layers_per_group) == (cj.num_groups, cj.layers_per_group)
        assert ct.total_params() == cj.total_params()
        assert ct.active_params() == cj.active_params()
        assert (ct.is_decoder, ct.supports_long_context) == (cj.is_decoder,
                                                            cj.supports_long_context)
    for name, shape in INPUT_SHAPES.items():
        specs = input_specs(reduced(t), shape)
        from repro.configs.shapes import input_specs as j_input_specs
        jspecs = j_input_specs(j_reduced(j), shape)
        assert {k: tuple(v.shape) for k, v in specs.items()} == \
            {k: tuple(v.shape) for k, v in jspecs.items()}, name


def test_every_reference_arch_is_ported():
    assert not UNPORTED_ARCHS
    assert list(ARCHS) == list(J_ARCHS)
    for name in J_ARCHS:
        assert get_config(name).name == name


def test_llama_cannot_cut_below_one_pattern():
    """Finding 1: at 4 layers llama's 5-long pattern leaves no group (the
    reference divides by zero too); 5 layers is the smallest cut."""
    for cfg in (get_config("llama-3.2-vision-90b"), j_get_config("llama-3.2-vision-90b")):
        with pytest.raises(ZeroDivisionError):
            dataclasses.replace(cfg, num_layers=4).num_groups
        assert dataclasses.replace(cfg, num_layers=5).num_groups == 1


@pytest.mark.parametrize("arch,layers", sorted(SIZES))
def test_full_size_parameter_counts(arch, layers):
    """The true sizes of the phase 22 cells and of llama at full depth
    (shapes on the meta device), equal to the reference's abstract
    ``init_params(cfg, None)``."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    shapes, _ = init_params(cfg, device="meta")
    n = sum(x.numel() for x in jax.tree_util.tree_leaves(shapes))
    assert n == SIZES[(arch, layers)]
    jshapes, _ = j_param_shapes(dataclasses.replace(j_get_config(arch), num_layers=layers))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jshapes))


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("arch", ARCHS_11C)
def test_param_tree_matches_reference(arch, tp):
    """Paths, shapes and metas of ``init_params`` at tp 1 and 2: the cross
    block's 0-d ``gate`` (model-synced, uncompressed) and no mixer, the
    GeLU MLP's ``w_up`` / ``w_down``, ``embed_in`` and ``img_proj``
    (replicated, compressed); the gates zero, as the reference's."""
    jcfg, tcfg = _cfgs(arch)
    jshapes, jmetas = j_param_shapes(jcfg, tp)
    tshapes, tmetas = init_params(tcfg, device="meta", tp=tp)
    js, ts = _paths(jshapes), _paths(tshapes)
    assert js.keys() == ts.keys()
    assert list(tshapes) == list(jshapes)  # the top level in the reference's order
    for k in js:
        assert tuple(ts[k].shape) == tuple(js[k].shape), k
    is_meta = dict(is_leaf=lambda x: hasattr(x, "tp_dim"))
    jm = _paths(jax.tree_util.tree_map(lambda m: m, jmetas, **is_meta))
    tm_ = _paths(jax.tree_util.tree_map(lambda m: m, tmetas, **is_meta))
    assert jm.keys() == tm_.keys()
    for k in jm:
        for f in META_FIELDS:
            assert getattr(tm_[k], f) == getattr(jm[k], f), (k, f)
    gates = [k for k in ts if k.endswith("['gate']")]
    assert len(gates) == (1 if tcfg.num_image_tokens else 0)
    tparams, _ = init_params(tcfg, 0, device="cpu", tp=tp)
    assert all(float(_paths(tparams)[k].abs().max()) == 0.0 for k in gates)


def test_zero_d_gate_through_storage_momentum_checkpoint_and_placement(tmp_path):
    """Finding 5: the gate, the port's first 0-d weight (stacked ``(R,)``
    in its group), goes through the spec tree (``REPL`` at tp 1 and 2),
    storage, momentum, a checkpoint byte-equal to the reference's (both
    packages load the other's) and a weight-stationary placement."""
    jcfg, tcfg = _cfgs("llama-3.2-vision-90b")
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.array, params)
    key = f"p{tcfg.pattern.index('cross')}"
    np_params["groups"][0][key]["attn"]["gate"] = np.asarray([0.75], np.float32)
    tparams = convert_lm_params(tcfg, np_params, device="cpu")
    _, tmetas = init_params(tcfg, device="meta")
    for tp in (1, 2):
        spec = build_spec_tree(tparams, tmetas, MeshCfg(tp=tp))["groups"][0][key]["attn"]["gate"]
        assert spec.kind == REPL and spec.logical == () and spec.reps == 1
    mesh, jmesh = MeshCfg(), JMesh()
    tspec = build_spec_tree(tparams, tmetas, mesh)
    tst = tree_to_storage(tparams, tspec, mesh)
    tmom = init_momentum(tst)
    gate = tst["groups"][0][key]["attn"]["gate"]
    assert tuple(gate.shape) == (1,) and tuple(tmom["groups"][0][key]["attn"]["gate"].shape) == (1,)
    jspec = j_build_spec_tree(jax.tree_util.tree_map(jnp.asarray, np_params), metas, jmesh)
    jst = j_tree_to_storage(jax.tree_util.tree_map(jnp.asarray, np_params), jspec, jmesh)
    nrt = tcfg.num_groups + 1
    rts = (2,) * nrt
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "ref")
    save_checkpoint(tdir, tst, tmom, None, 3, plan=PrecisionPlan.build(nrt, round_to=2),
                    spec_tree=tspec, round_tos=rts)
    j_save_checkpoint(jdir, jst, j_init_momentum(jst), None, 3, plan=JPlan.build(nrt, round_to=2),
                      spec_tree=jspec, round_tos=rts)
    td, jd = (os.path.join(d + ".ckpt") for d in (tdir, jdir))
    files = sorted(f for f in os.listdir(jd) if f.endswith(".bin"))
    assert files and files == sorted(f for f in os.listdir(td) if f.endswith(".bin"))
    for f in files:
        with open(os.path.join(td, f), "rb") as a, open(os.path.join(jd, f), "rb") as b:
            assert a.read() == b.read(), f
    st2, mom2, step = load_checkpoint(jdir, tst, tmom)
    assert step == 3 and float(st2["groups"][0][key]["attn"]["gate"][0]) == 0.75
    jst2, _, _ = j_load_checkpoint(tdir, jst, j_init_momentum(jst))
    assert float(jst2["groups"][0][key]["attn"]["gate"][0]) == 0.75
    placed = make_place_step(tcfg, mesh, None, tspec, plan=PrecisionPlan.build(nrt, round_to=2))(tst)
    assert float(placed["groups"][0][key]["attn"]["gate"][0]) == 0.75


def test_serve_cache_shapes_match_reference():
    """llama's caches on a rank at tp 2 against the reference's global
    shapes divided along its ``cache_pspecs``' model axis: the cross
    block's image KV (16 rows of the rank's 2 kv heads, scalar ``pos``)
    and the self-attention blocks' KV."""
    jcfg, tcfg = _cfgs("llama-3.2-vision-90b")
    jmesh = JMesh(tp=2)
    glob = jserve.global_cache_shapes(jcfg, jmesh, 2, 24)
    specs = jserve.cache_pspecs(jcfg, jmesh, True)
    local = tserve.init_serve_caches(tcfg, MeshCfg(tp=2), 2, 24)
    for key, node in local[0].items():
        jl = jax.tree_util.tree_leaves(glob[0][key])
        jp = jax.tree_util.tree_leaves(specs[0][key],
                                       is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        tl = (node.k, node.v, node.pos)
        assert len(jl) == len(tl), key
        for a, spec, b in zip(jl, jp, tl):
            want = tuple(n // 2 if ax == "model" else n for n, ax in
                         zip(a.shape, tuple(spec) + (None,) * (len(a.shape) - len(spec))))
            assert tuple(b.shape) == want, (key, a.shape, spec, b.shape)
    assert local[0]["p4"].k.shape[2] == tcfg.num_image_tokens
