"""Vision cross-attention (llama-3.2-vision-90b) and the audio encoder
(hubert-xlarge) across gloo ranks: the port against the JAX reference at
tp 2, at ``reduced()`` (llama: one ``(attn × 4, cross)`` pattern, 16 image
tokens; hubert: 2 layers, 32-wide frame features).

The reference runs in one subprocess of this file (``python
tests/test_torch_vision_mesh.py INPUTS OUT``) with 4 emulated host
devices: ``make_train_step`` at ``MeshCfg(tp=2, dp=2)`` (the jitted
function without its donation), two steps at ``round_to`` 2 from its
``init_params(cfg, PRNGKey(0), tp=2)`` weights, llama's cross gates set to
a seeded value in (0.5, 1.0) (its zero init would hide a broken cross
path), on llama's ``synthetic_lm_batch`` with seeded image features and
hubert's ``synthetic_feature_batch`` at B 8, S 16; and llama's greedy
``generate_static`` with image features at ``MeshCfg(tp=2)``. The port
runs 4 gloo ranks for the 2×2 training and 2 for the 1×2 serving
(``spawn_ranks``, one CPU thread each), from the same weights as numpy
trees.

Training (2×2): losses within rtol 1e-5, Σw² within rtol 1e-5, every
rank's updated shards within atol 1e-6 and a relative l2 of the update of
1e-3 (``tests/test_torch_moe_mesh.py``'s bars); the measured wire per
priced class equal to ``step_wire_table`` at every step: the cross
block's enter / exit pair, its image KV's backward all-reduce of ``(B /
dp, N, d)``, hubert's missing embedding exit. The port alone, with
``remat`` on, in the psum and sequence-parallel layouts: the same.

Serving (1×2): each arch's last-token prefill logits within atol 2e-5 /
rtol 1e-5 of the reference's ``make_prefill_step`` at tp 2; llama's
static streams equal the reference's at tp 2 and the port's one device;
one prefill and one decode step's wire equal ``serve_wire_table`` in both
layouts.
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
ARCHS = ("llama-3.2-vision-90b", "hubert-xlarge")
LOSS_RTOL = NORM_RTOL = 1e-5
LOGIT_TOL = dict(atol=2e-5, rtol=1e-5)
UPDATE_ATOL, UPDATE_REL = 1e-6, 1e-3
PRICED = ("weights", "gradients", "activations", "seq_boundary")
LENS, GEN = (16, 16, 16), 4


# The ranks import this file and run the port alone: JAX and the reference
# are imported inside the functions that use them, and the ranks receive
# the reference's weights already converted, as numpy trees.


def _tcfg(arch):
    from repro_torch.configs.registry import get_config, reduced

    return reduced(get_config(arch))


def _jcfg(arch):
    from repro.configs.registry import get_config, reduced

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


def _batch(arch, step):
    """Step ``step``'s global batch as numpy: llama's k-gram tokens and
    seeded image features, hubert's frame features."""
    from repro_torch.data.pipeline import synthetic_feature_batch, synthetic_lm_batch

    cfg = _tcfg(arch)
    if cfg.embed_is_input_stub:
        f, lab = synthetic_feature_batch(cfg.vision_dim, cfg.vocab_size, B, S, step, device="cpu")
        return {"features": f.numpy(), "labels": lab.numpy()}
    t, lab = synthetic_lm_batch(cfg.vocab_size, B, S, step, device="cpu")
    img = np.random.default_rng(100 + step).normal(0, 1, (B, cfg.num_image_tokens,
                                                          cfg.vision_dim))
    return {"tokens": t.numpy(), "labels": lab.numpy(), "image_features": img.astype(np.float32)}


def _prefill_batch(arch):
    """Two 16-long rows of a prefill: hubert's frames, or llama's one
    prompt twice with two images."""
    cfg = _tcfg(arch)
    rng = np.random.default_rng(9)
    if cfg.embed_is_input_stub:
        return {"features": rng.normal(0, 1, (2, 16, cfg.vision_dim)).astype(np.float32)}
    return {"tokens": np.repeat(rng.integers(0, cfg.vocab_size, (1, 16)), 2, 0).astype(np.int32),
            "image_features": _images()[:2]}


def _images():
    cfg = _tcfg("llama-3.2-vision-90b")
    rng = np.random.default_rng(7)
    return rng.normal(0, 1, (len(LENS), cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)


def _prompts(vocab):
    """Requests 0 and 1 share their prompt (and carry different images)."""
    rng = np.random.default_rng(11)
    p0 = tuple(int(t) for t in rng.integers(0, vocab, LENS[0]))
    return [p0, p0, tuple(int(t) for t in rng.integers(0, vocab, LENS[2]))]


def _inputs() -> dict:
    """The reference's ``init_params(cfg, PRNGKey(0), tp=2)`` of each arch,
    the same tree as at tp 1 (at ``reduced()`` no head count or vocabulary
    is padded), with the cross gates drawn from a seed."""
    import jax

    from repro.models.init import init_params as j_init_params

    out = {}
    for arch in ARCHS:
        params, _ = j_init_params(_jcfg(arch), jax.random.PRNGKey(0), tp=TP)
        rng = np.random.default_rng(3)
        for k, v in _paths(params).items():
            v = np.asarray(v)
            if k.endswith("['gate']"):  # the reference's zero gates hide the cross path
                v = rng.uniform(0.5, 1.0, v.shape).astype(np.float32)
            out[f"{arch}/w{k}"] = v
    return out


def _params(inputs, arch):
    import jax

    from repro.models.init import init_params as j_init_params

    shapes = jax.eval_shape(lambda k: j_init_params(_jcfg(arch), k, tp=TP)[0],
                            jax.random.PRNGKey(0))
    flat = [inputs[f"{arch}/w{k}"] for k in _paths(shapes)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), flat)


def _converted(inputs):
    """The reference's weights in the port's layout, as numpy."""
    from repro_torch.convert import convert_lm_params
    from repro_torch.utils.trees import tree_map

    return {arch: tree_map(lambda t: t.numpy(), convert_lm_params(
        _tcfg(arch), _params(inputs, arch), device="cpu", tp=TP)) for arch in ARCHS}


def _reference(inputs_path, out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.dist.spec import MeshCfg as JMesh
    from repro.dist.spec import build_spec_tree, leaf_partition_spec, tree_to_storage
    from repro.launch.mesh import make_mesh_from_cfg
    from repro.models.init import init_params as j_init_params
    from repro.optim.sgd import SGDConfig, init_momentum
    from repro.plan import PrecisionPlan as JPlan
    from repro.serve import engine as jeng
    from repro.serve.step import make_prefill_step
    from repro.train.step import make_train_step

    inputs = dict(np.load(inputs_path))
    res = {}
    mcfg = JMesh(tp=TP, dp=DP)
    mesh = make_mesh_from_cfg(mcfg)
    devs = list(mesh.devices.flat)
    opt = SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4)
    for arch in ARCHS:
        jcfg = _jcfg(arch)
        params = jax.tree_util.tree_map(jnp.asarray, _params(inputs, arch))
        _, metas = j_init_params(jcfg, None, tp=TP)
        spec = build_spec_tree(params, metas, mcfg)
        specs = _paths(spec)
        plan = JPlan.build(jcfg.num_groups + 1, round_to=2)
        shapes = {k: jax.ShapeDtypeStruct(v.shape, jnp.asarray(v).dtype)
                  for k, v in _batch(arch, 0).items()}
        with mesh:
            step = jax.jit(make_train_step(jcfg, mcfg, mesh, spec, opt, shapes,
                                           plan=plan).__wrapped__)
            st = tree_to_storage(params, spec, mcfg)
            mom = init_momentum(st)
            for i in range(STEPS):
                batch = {k: jnp.asarray(v) for k, v in _batch(arch, i).items()}
                st, mom, m = step(st, mom, batch, LR)
                res[f"{arch}/loss/{i}"] = np.asarray(m["loss"])
                res[f"{arch}/norms/{i}"] = np.asarray(m["group_norms_sq"])
        for k, v in _paths(st).items():
            placed = jax.device_put(v, NamedSharding(mesh, leaf_partition_spec(specs[k], mcfg)))
            for s in placed.addressable_shards:
                res[f"{arch}/final/{devs.index(s.device)}{k}"] = np.asarray(s.data)
        # prefill logits and greedy generate_static at tp 2 (a 1×2 mesh's model axis)
        scfg = JMesh(tp=TP)
        smesh = make_mesh_from_cfg(scfg)
        sspec = build_spec_tree(params, metas, scfg)
        pb = {k: jnp.asarray(v) for k, v in _prefill_batch(arch).items()}
        with smesh:
            pre = make_prefill_step(jcfg, scfg, smesh, sspec,
                                    {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                     for k, v in pb.items()}, plan=plan, cache_capacity=16)
            res[f"{arch}/logits"] = np.asarray(pre(tree_to_storage(params, sspec, scfg), pb)[0])
        if not jcfg.causal:
            continue
        img = _images()
        reqs = [jeng.Request(rid=i, prompt_ids=p, max_new=GEN, image_features=img[i])
                for i, p in enumerate(_prompts(jcfg.vocab_size))]
        with smesh:
            streams = jeng.generate_static(jcfg, scfg, smesh, sspec,
                                           tree_to_storage(params, sspec, scfg), reqs, plan=plan)
        for rid, toks in streams.items():
            res[f"{arch}/stream/{rid}"] = np.asarray(toks)
    np.savez(out_path, **res)


def _train_rank(rank, weights):
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

    def batch(arch, i):
        return {k: torch.from_numpy(v) for k, v in _batch(arch, i).items()}

    for arch in ARCHS:
        tcfg = _tcfg(arch)
        params = tree_map(torch.from_numpy, weights[arch])
        _, metas = init_params(tcfg, device="meta", tp=TP)
        spec = build_spec_tree(params, metas, mcfg)
        st = tree_to_local(tree_to_storage(params, spec, mcfg), spec, mcfg, rank)
        out.update({f"{arch}/start{k}": v.numpy().copy() for k, v in _port_paths(st).items()})
        mom = init_momentum(st)
        plan = PrecisionPlan.build(tcfg.num_groups + 1, round_to=2)
        shapes = {k: tuple(v.shape) for k, v in batch(arch, 0).items()}
        step = make_train_step(tcfg, mcfg, mesh, spec, opt, shapes, plan=plan)
        for i in range(STEPS):
            first = len(comm.LOG)
            st, mom, met = step(st, mom, batch(arch, i), LR)
            out[f"{arch}/loss/{i}"] = met["loss"].numpy()
            out[f"{arch}/norms/{i}"] = met["group_norms_sq"].numpy()
            out[f"{arch}/wire/{i}"] = comm.wire_by_traffic(comm.LOG[first:])
        out[f"{arch}/table"] = step_wire_table(plan, tcfg, spec, mcfg, (B, S))
        out.update({f"{arch}/final{k}": v.numpy().copy() for k, v in _port_paths(st).items()})
        # remat (the full-width configs' default), psum and sequence-parallel: port only
        cfg = dataclasses.replace(tcfg, remat=True)
        for sp in (False, True):
            plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2, seq_parallel=sp)
            step = make_train_step(cfg, mcfg, mesh, spec, SGDConfig(lr=LR), shapes, plan=plan)
            st = tree_to_local(tree_to_storage(tree_map(torch.from_numpy, weights[arch]), spec,
                                               mcfg), spec, mcfg, rank)
            first = len(comm.LOG)
            step(st, init_momentum(st), batch(arch, 0), LR)
            out[f"{arch}/remat/{sp}"] = (comm.wire_by_traffic(comm.LOG[first:]),
                                         step_wire_table(plan, cfg, spec, mcfg, (B, S)))
        del comm.LOG[:]
    return out


def _serve_rank(rank, weights):
    """Each arch's prefill logits at 1×2; llama's static run, and one
    prefill and one decode step's wire against ``serve_wire_table`` in the
    psum and seq-parallel layouts."""
    from repro_torch.dist import comm
    from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_local, tree_to_storage
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.models.init import init_params
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.api import Request
    from repro_torch.serve.engine import generate_static
    from repro_torch.serve.step import make_decode_step, make_prefill_step, serve_wire_table
    from repro_torch.train.step import COLLECTIVE_CLASSES
    from repro_torch.utils.trees import tree_map

    mcfg = MeshCfg(tp=TP)
    mesh = make_mesh_from_cfg(mcfg)
    out = {}
    for arch in reversed(ARCHS):  # llama's set-up last: the runs below use it
        tcfg = _tcfg(arch)
        params = tree_map(torch.from_numpy, weights[arch])
        _, metas = init_params(tcfg, device="meta", tp=TP)
        spec = build_spec_tree(params, metas, mcfg)
        st = tree_to_local(tree_to_storage(params, spec, mcfg), spec, mcfg, rank)
        plan = PrecisionPlan.build(tcfg.num_groups + 1, round_to=2)
        pb = {k: torch.from_numpy(v) for k, v in _prefill_batch(arch).items()}
        out[f"{arch}/logits"] = make_prefill_step(tcfg, mcfg, mesh, spec, plan=plan,
                                                  cache_capacity=16)(st, pb)[0].numpy()
    img = _images()
    reqs = [Request(rid=i, prompt_ids=p, max_new=GEN, image_features=img[i])
            for i, p in enumerate(_prompts(tcfg.vocab_size))]
    out["static"] = generate_static(tcfg, mcfg, mesh, spec, st, reqs, plan=plan)
    rows, n = 2, LENS[0]
    batch = {"tokens": torch.tensor([reqs[0].prompt_ids] * rows, dtype=torch.int32),
             "image_features": torch.from_numpy(img[:rows])}
    for sp in (False, True):
        plan = PrecisionPlan.build(tcfg.num_groups + 1, round_to=2, seq_parallel=sp)
        first = len(comm.LOG)
        _, caches = make_prefill_step(tcfg, mcfg, mesh, spec, plan=plan,
                                      cache_capacity=n + 1)(st, batch)
        pre = comm.wire_by_traffic(comm.LOG[first:])
        first = len(comm.LOG)
        make_decode_step(tcfg, mcfg, mesh, spec, plan=plan)(
            st, caches, {"tokens": batch["tokens"][:, :1], "pos": torch.tensor(n)})
        dec = comm.wire_by_traffic(comm.LOG[first:])
        want_pre = serve_wire_table(plan, tcfg, spec, mcfg, rows=rows, tokens=n, seq_parallel=sp)
        want_dec = serve_wire_table(plan, tcfg, spec, mcfg, rows=rows, tokens=1)
        out[f"wire_ok/{sp}"] = all(pre.get(k, 0) == want_pre[k] and dec.get(k, 0) == want_dec[k]
                                   for k in COLLECTIVE_CLASSES)
        out[f"seq_wire/{sp}"] = pre.get("seq_boundary", 0)
    del comm.LOG[:]
    return out


def _one_device_streams(inputs):
    """The port's one-device greedy static streams from the same weights."""
    from repro_torch.convert import convert_lm_params
    from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_storage
    from repro_torch.models.init import init_params
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.api import Request
    from repro_torch.serve.engine import generate_static

    arch = "llama-3.2-vision-90b"
    tcfg = _tcfg(arch)
    params = convert_lm_params(tcfg, _params(inputs, arch), device="cpu")
    _, metas = init_params(tcfg, device="meta")
    spec = build_spec_tree(params, metas, MeshCfg())
    img = _images()
    reqs = [Request(rid=i, prompt_ids=p, max_new=GEN, image_features=img[i])
            for i, p in enumerate(_prompts(tcfg.vocab_size))]
    return generate_static(tcfg, MeshCfg(), None, spec, tree_to_storage(params, spec, MeshCfg()),
                           reqs, plan=PrecisionPlan.build(tcfg.num_groups + 1, round_to=2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_ranks

    tmp = tmp_path_factory.mktemp("vision_mesh")
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
        one = _one_device_streams(inputs)
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
    """Every rank's shards after two steps, as updates from the start (the
    cross gates' and ``img_proj``'s, hubert's ``embed_in``'s among them)."""
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
            if k.endswith("['gate']"):
                assert np.abs(du).max() > 0, (r, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_prefill_logits_match_reference(runs, arch):
    """Last-token logits of a 2-row prefill at tp 2, gathered over the
    model group, on both ranks; llama's rows (one prompt, two images)
    apart by far more than the tolerance."""
    ref, _, serve, _ = runs
    for p in serve:
        np.testing.assert_allclose(p[f"{arch}/logits"], ref[f"{arch}/logits"], **LOGIT_TOL)
    if arch.startswith("llama"):
        got = serve[0][f"{arch}/logits"]
        assert np.abs(got[0] - got[1]).max() > 100 * LOGIT_TOL["atol"]


@pytest.mark.parametrize("arch", ARCHS)
def test_measured_wire_equals_step_wire_table(runs, arch):
    """Per priced class, every step on every rank; then the remat runs in
    both layouts (the image KV's all-reduce stays in ``activations`` under
    the sequence-parallel layout)."""
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
            assert (wire.get("activations", 0) > 0) == (not sp or arch.startswith("llama"))


def test_tp2_static_streams_and_wire(runs):
    """llama's 1×2 static run equals the reference's greedy
    ``generate_static`` at tp 2 and the port's one device, on both ranks;
    a prefill's and a decode step's wire equal ``serve_wire_table`` in
    the psum and sequence-parallel layouts."""
    ref, _, serve, one = runs
    want = {rid: ref[f"llama-3.2-vision-90b/stream/{rid}"].tolist() for rid in range(len(LENS))}
    assert one == want
    for p in serve:
        assert p["static"] == want
        for sp in (False, True):
            assert p[f"wire_ok/{sp}"]
            assert (p[f"seq_wire/{sp}"] > 0) == sp


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
