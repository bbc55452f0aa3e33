"""Speculative decoding and sliding windows at tp 2, chunked stochastic
gathers across data ranks, and the serve launcher's request, chunk and
layout flags: the port against the JAX reference.

The reference's outputs come from one subprocess of this file (``python
tests/test_torch_tp_spec.py INPUTS OUT``) with 2 emulated host devices:
its greedy ``generate_static`` at ``MeshCfg(tp=2)`` with and without a
``WINDOW``-token window (its engine, and so its speculative engine, fails
at any mesh under jax 0.9.0, and its sampled ``generate_static`` too:
ROADMAP "Reference caveats"), and reduced AlexNet's weights materialized
by its ``_mat`` inside ``shard_map`` at ``MeshCfg(dp=2)`` under a plan of
stochastic weights at round_to 2 in 2 chunks. The port runs as 2 gloo
ranks (``spawn_ranks``, one CPU thread each). Inputs: reduced qwen3-1.7b
with the reference's ``init_params(cfg, PRNGKey(0), tp=2)`` weights
converted, prompts 16, 12, 16, 8 from ``default_rng(0)``, ``GEN`` new
tokens, greedy or sampled at temperature 0.8, top-p 0.95, top-k 40, seeds
100 + i; the tiny draft's weights are random from seed 1.

Exact, token for token and bit for bit:

* at tp 2, the speculative engine (the target as its own draft, the tiny
  draft, and the self draft over paged KV) equals the tp-2 engine without
  a draft and the one-device speculative engine; the greedy streams equal
  the reference's ``generate_static`` at the mesh; every rank streams the
  same; the self draft accepts every proposal;
* at tp 2 the windowed static run equals the ring engine and the
  one-device ring engine; the greedy one equals the reference's windowed
  ``generate_static`` at the mesh;
* at dp 2 with ``chunks`` 2 the stochastic weights are the reference's
  (each element's noise drawn under the key of the reference's chunk that
  holds it, through the noise index);
* the serve launcher's ``--requests`` / ``--prompt-len``, ``--chunks``,
  ``--static`` and ``--contiguous`` print the reference launcher's streams.
"""
from __future__ import annotations

import contextlib
import io
import os
import re
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
LENS, GEN, SLOTS, SPEC_K, WINDOW = (16, 12, 16, 8), 8, 2, 3, 12
SAMPLING = dict(temperature=0.8, top_p=0.95, top_k=40, seed=100)
DRAFTS = ("self", "tiny", "self-paged")
MIN_SIZE = 256  # the CNN example's compress_min_size for the mini-nets
CNN_KEY = 1000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _paths(tree):
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _lm_cfgs():
    from repro_torch.configs.registry import get_config, reduced

    return j_reduced(j_get_config("qwen3-1.7b")), reduced(get_config("qwen3-1.7b"))


def _cnn_cfgs():
    from repro.models import cnn as jc
    from repro_torch.models import cnn as tc

    return (jc.reduced_cnn(jc.ALEXNET, num_classes=10, in_hw=32),
            tc.reduced_cnn(tc.ALEXNET, num_classes=10, in_hw=32))


def _inputs() -> dict:
    from repro.models import cnn as jc

    jcfg, _ = _lm_cfgs()
    params, _ = j_init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    out = {f"w{k}": np.asarray(v) for k, v in _paths(params).items()}
    rng = np.random.default_rng(0)
    for i, S in enumerate(LENS):
        out[f"prompt{i}"] = rng.integers(0, jcfg.vocab_size, S).astype(np.int32)
    ccfg, _ = _cnn_cfgs()
    shapes = jax.eval_shape(lambda k: jc.init_cnn(ccfg, k)[0], jax.random.PRNGKey(0))
    wrng = np.random.default_rng(1)
    for name, leafs in shapes["layers"].items():
        for k, s in leafs.items():
            std = np.sqrt(2.0 / np.prod(s.shape[:-1])) if k == "w" else 0.1
            out[f"cnn/{name}/{k}"] = (std * wrng.standard_normal(s.shape)).astype(np.float32)
    return out


def _lm_params(inputs):
    jcfg, _ = _lm_cfgs()
    shapes = jax.eval_shape(lambda k: j_init_params(jcfg, k, tp=TP)[0], jax.random.PRNGKey(0))
    flat = [inputs[f"w{k}"] for k in _paths(shapes)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), flat)


def _cnn_tree(inputs) -> dict:
    layers: dict = {}
    for key, a in inputs.items():
        if key.startswith("cnn/"):
            _, name, k = key.split("/")
            layers.setdefault(name, {})[k] = a
    return {"layers": layers}


def _prompts(inputs):
    return [tuple(int(t) for t in inputs[f"prompt{i}"]) for i in range(len(LENS))]


def _requests(Request, SamplingParams, inputs, sampled: bool):
    def sp(i):
        if not sampled:
            return SamplingParams()
        return SamplingParams(temperature=SAMPLING["temperature"], top_p=SAMPLING["top_p"],
                              top_k=SAMPLING["top_k"], seed=SAMPLING["seed"] + i)

    return [Request(rid=i, prompt_ids=p, max_new=GEN, sampling=sp(i))
            for i, p in enumerate(_prompts(inputs))]


# ---------------------------------------------------------------------------
# the reference (a subprocess of this file, 2 emulated host devices)
# ---------------------------------------------------------------------------


def _reference(inputs_path, out_path):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.dist.shard import shard_map
    from repro.dist.spec import LeafSpec
    from repro.dist.spec import MeshCfg as JMesh
    from repro.dist.spec import build_spec_tree, leaf_partition_spec, tree_to_storage
    from repro.launch.mesh import make_mesh_from_cfg
    from repro.models import cnn as jc
    from repro.plan import PrecisionPlan as JPlan
    from repro.serve.api import SamplingParams
    from repro.serve.engine import Request, generate_static
    from repro.train import cnn_step as jstep

    inputs = dict(np.load(inputs_path))
    res = {}
    jcfg, _ = _lm_cfgs()
    params = jax.tree_util.tree_map(jnp.asarray, _lm_params(inputs))
    _, metas = j_init_params(jcfg, None, tp=TP)
    mcfg = JMesh(tp=TP)
    mesh = make_mesh_from_cfg(mcfg)
    spec = build_spec_tree(params, metas, mcfg)
    storage = tree_to_storage(params, spec, mcfg)
    plan = JPlan.build(jcfg.num_groups + 1, round_to=2)
    requests = _requests(Request, SamplingParams, inputs, False)
    with mesh:
        for label, window in (("static", None), ("window", WINDOW)):
            streams = generate_static(jcfg, mcfg, mesh, spec, storage, requests, plan=plan,
                                      window=window)
            for rid, ids in streams.items():
                res[f"{label}/{rid}"] = np.array(ids)

    ccfg, _ = _cnn_cfgs()
    box = {}

    def init(key):
        p, box["metas"], box["gi"] = jc.init_cnn(ccfg, key)
        return p

    jax.eval_shape(init, jax.random.PRNGKey(0))
    groups, ng = box["gi"]
    cmcfg = JMesh(tp=1, dp=2, compress_min_size=MIN_SIZE)
    cmesh = make_mesh_from_cfg(cmcfg)
    cparams = jax.tree_util.tree_map(jnp.asarray, _cnn_tree(inputs))
    cspec = jstep.build_cnn_spec_tree(cparams, box["metas"], cmcfg)
    cstorage = jstep.cnn_to_storage(cparams, cspec, cmcfg)
    policies = JPlan.build(ng, round_to=2, mode="stochastic", chunks=2).weight_policies()
    pspecs = jax.tree_util.tree_map(lambda s: leaf_partition_spec(s, cmcfg), cspec,
                                    is_leaf=lambda x: isinstance(x, LeafSpec))
    rng = jax.random.fold_in(jax.random.PRNGKey(CNN_KEY), 0xAD7)
    mat = shard_map(lambda st: jstep._mat(st, cspec, cmcfg, groups, policies, rng),
                    mesh=cmesh, in_specs=(pspecs,), out_specs=P())
    with cmesh:
        for name, leafs in jax.jit(mat)(cstorage).items():
            for k, v in leafs.items():
                res[f"cnn/{name}/{k}"] = np.asarray(v)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _serve_runs(tcfg, mcfg, mesh, spec, storage, inputs, device="cpu") -> dict:
    """Every stream the port serves on one rank of ``mcfg`` (the trivial
    mesh included): ``{(label, sampled): {rid: ids}}``, plus the self
    draft's acceptance."""
    from repro_torch.dist import comm
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.engine import Request, SamplingParams, ServeEngine, generate_static
    from repro_torch.models.init import init_params
    from repro_torch.serve.spec import DraftBundle, build_draft, make_draft_config

    plan = PrecisionPlan.build(tcfg.num_groups + 1, round_to=2)
    cap = max(LENS) + GEN
    # the tiny draft from seed 1 at tp 2 on every mesh: the same weights
    dparams = None
    if mcfg.trivial:
        dparams, _ = init_params(make_draft_config(tcfg, "tiny"), 1, device=device, tp=TP)
    drafts = {"self": DraftBundle(tcfg, spec, storage),
              "tiny": build_draft(tcfg, mcfg, "tiny", device=device, params=dparams)}
    out = {}

    def engine(requests, **kw):
        first = len(comm.LOG)
        eng = ServeEngine(tcfg, mcfg, mesh, spec, storage, plan=plan, max_slots=SLOTS, **kw)
        res = eng.run(requests)
        summary = eng.wire_summary()
        if not mcfg.trivial:  # what the wire log, its tables and comm.LOG say
            tables = eng.wire_tables()
            summary["tables"] = {k: sum(t[k] for t in tables) for k in tables[0]}
            summary["logged"] = comm.wire_by_traffic(comm.LOG[first:])
            summary["kinds"] = sorted({r["kind"] for r in eng.wire_log})
        return {rid: r.tokens for rid, r in res.items()}, summary

    for sampled in (False, True):
        requests = _requests(Request, SamplingParams, inputs, sampled)
        out["engine", sampled], _ = engine(requests, cache_capacity=cap)
        for label in DRAFTS:
            out[label, sampled], summary = engine(
                requests, cache_capacity=cap, draft=drafts[label.split("-")[0]],
                spec_k=SPEC_K, paged=label.endswith("paged"), page_size=8)
            out["acceptance", label, sampled] = summary["acceptance_rate"]
            out["wire", label, sampled] = {k: summary.get(k)
                                           for k in ("wire", "tables", "logged", "kinds")}
        out["window-static", sampled] = generate_static(tcfg, mcfg, mesh, spec, storage,
                                                        requests, plan=plan, window=WINDOW)
        out["window", sampled], _ = engine(requests, cache_capacity=WINDOW, window=WINDOW)
    return out


def _port_lm_rank(rank, inputs):
    from repro_torch.convert import convert_lm_params
    from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_local, tree_to_storage
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.models.init import init_params

    _, tcfg = _lm_cfgs()
    mcfg = MeshCfg(tp=TP)
    mesh = make_mesh_from_cfg(mcfg)
    params = convert_lm_params(tcfg, _lm_params(inputs), device="cpu", tp=TP)
    _, metas = init_params(tcfg, device="meta", tp=TP)
    spec = build_spec_tree(params, metas, mcfg)
    storage = tree_to_local(tree_to_storage(params, spec, mcfg), spec, mcfg, rank)
    return _serve_runs(tcfg, mcfg, mesh, spec, storage, inputs)


def _one_device(inputs) -> dict:
    from repro_torch.convert import convert_lm_params
    from repro_torch.dist.spec import MeshCfg, build_spec_tree
    from repro_torch.models.init import init_params

    _, tcfg = _lm_cfgs()
    mcfg = MeshCfg()
    params = convert_lm_params(tcfg, _lm_params(inputs), device="cpu", tp=TP)
    _, metas = init_params(tcfg, device="meta", tp=TP)
    spec = build_spec_tree(params, metas, mcfg)
    return _serve_runs(tcfg, mcfg, None, spec, params, inputs)


def _port_cnn_rank(rank, inputs):
    from repro_torch import random as jr
    from repro_torch.convert import convert_cnn_params
    from repro_torch.dist.spec import MeshCfg, tree_to_local
    from repro_torch.launch.mesh import fsdp_group, make_mesh_from_cfg
    from repro_torch.models.cnn import init_cnn
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train import cnn_step as tstep

    _, tcfg = _cnn_cfgs()
    _, metas, (groups, ng) = init_cnn(tcfg, 0, device="meta")
    mcfg = MeshCfg(dp=2, compress_min_size=MIN_SIZE)
    mesh = make_mesh_from_cfg(mcfg)
    params = convert_cnn_params(tcfg, _cnn_tree(inputs), device="cpu")
    spec = tstep.build_cnn_spec_tree(params, metas, mcfg)
    storage = tree_to_local(tstep.cnn_to_storage(params, spec, mcfg), spec, mcfg, rank)
    policies = PrecisionPlan.build(ng, round_to=2, mode="stochastic", chunks=2).weight_policies()
    rng = jr.fold_in(jr.PRNGKey(CNN_KEY), 0xAD7)
    layers = tstep._mat(storage, spec, mcfg, groups, policies, group=fsdp_group(mesh), rng=rng,
                        indices=tstep.noise_indices(spec, mcfg, "cpu", rank))
    chunked = sum(s.kind == "dist" and (s.pad_rep // 2) % 2 == 0
                  for leafs in spec["layers"].values() for s in leafs.values())
    return {"chunked": chunked,
            **{f"cnn/{name}/{k}": v.detach().numpy() for name, leafs in layers.items()
               for k, v in leafs.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, tp-2 ranks' runs, one device's runs, CNN ranks'
    materializations, inputs): the reference subprocess runs while the
    port's ranks do."""
    from repro_torch.launch.mesh import spawn_ranks

    tmp = tmp_path_factory.mktemp("tp_spec")
    inputs = _inputs()
    inp, out = str(tmp / "inputs.npz"), str(tmp / "ref.npz")
    np.savez(inp, **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), inp, out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lm = spawn_ranks(_port_lm_rank, TP, inputs)
        cnn = spawn_ranks(_port_cnn_rank, 2, inputs)
        one = _one_device(inputs)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference failed:\n{stdout[-3000:]}\n{stderr[-3000:]}"
    return dict(np.load(out)), lm, one, cnn, inputs


def _ref_streams(ref, label):
    return {rid: ref[f"{label}/{rid}"].tolist() for rid in range(len(LENS))}


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("draft", DRAFTS)
def test_spec_streams_at_tp2(runs, draft, sampled):
    """The tp-2 speculative engine streams the tp-2 engine's tokens and the
    one-device speculative engine's, on both ranks alike; greedy, the
    reference's ``generate_static`` at the mesh."""
    ref, lm, one, _, _ = runs
    for r, p in enumerate(lm):
        assert p[draft, sampled] == p["engine", sampled], f"rank {r}"
        assert p[draft, sampled] == lm[0][draft, sampled], f"rank {r}"
    assert lm[0][draft, sampled] == one[draft, sampled] == one["engine", sampled]
    if not sampled:
        assert lm[0][draft, sampled] == _ref_streams(ref, "static")


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_self_draft_accepts_everything_at_tp2(runs, sampled):
    """The self draft accepts every proposal; the tiny draft (the same
    seed-1 weights on both meshes) accepts on the tp-2 ranks exactly what
    it accepts on one device, so its blocks are the rank's own."""
    _, lm, one, _, _ = runs
    for label in DRAFTS:
        assert [p["acceptance", label, sampled] for p in lm] == [
            one["acceptance", label, sampled]] * 2, label
    assert one["acceptance", "self", sampled] == one["acceptance", "self-paged", sampled] == 1.0


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("draft", DRAFTS)
def test_draft_wire_is_logged_and_priced_at_tp2(runs, draft, sampled):
    """At tp 2 every draft forward has a ``wire_log`` entry of its own
    (``draft_prefill``, ``draft_decode``): ``wire_summary()["wire"]``
    equals everything ``comm.LOG`` holds of the run, class by class, and
    in each class ``serve_wire_table`` prices (the draft's under its own
    plan, config and spec tree) the sum of ``wire_tables()``. Before, the
    draft's collectives were in no entry."""
    _, lm, _, _, _ = runs
    for r, p in enumerate(lm):
        w = p["wire", draft, sampled]
        assert w["kinds"] == ["draft_decode", "draft_prefill", "prefill", "verify"], f"rank {r}"
        assert w["wire"] == w["logged"], f"rank {r}"
        for k in ("weights", "gradients", "activations", "seq_boundary"):
            assert w["wire"].get(k, 0) == w["tables"][k], f"rank {r} {k}"
        assert set(w["wire"]) <= {"weights", "activations", "logits"}, f"rank {r}"


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_window_at_tp2(runs, sampled):
    """A ``WINDOW``-token window at tp 2: the windowed static run (linear
    cache, window mask) equals the ring engine and one device's; greedy,
    the reference's windowed ``generate_static`` at the mesh. The window
    bites: the streams leave the unwindowed ones."""
    ref, lm, one, _, _ = runs
    for r, p in enumerate(lm):
        assert p["window", sampled] == p["window-static", sampled], f"rank {r}"
    assert lm[0]["window", sampled] == lm[1]["window", sampled] == one["window", sampled]
    assert lm[0]["window", sampled] != lm[0]["engine", sampled]
    if not sampled:
        assert lm[0]["window-static", False] == _ref_streams(ref, "window")


def test_chunked_stochastic_cnn_weights_equal_reference(runs):
    """Reduced AlexNet's weights at dp 2 under stochastic rounding in 2
    chunks, gathered and unpacked on each rank, bit-equal to the
    reference's (converted to the port's layout): the noise of every
    element comes from the reference's chunk key at its index there."""
    from repro_torch.convert import convert_cnn_params

    ref, _, _, cnn, inputs = runs
    _, tcfg = _cnn_cfgs()
    tree = _cnn_tree(inputs)
    logical = {"layers": {name: {k: ref[f"cnn/{name}/{k}"] for k in leafs}
                          for name, leafs in tree["layers"].items()}}
    want = convert_cnn_params(tcfg, logical, device="cpu")
    assert cnn[0]["chunked"] >= 3  # leaves whose shard splits in 2 chunks
    for r, got in enumerate(cnn):
        for name, leafs in want["layers"].items():
            for k, v in leafs.items():
                np.testing.assert_array_equal(got[f"cnn/{name}/{k}"].view(np.uint32),
                                              v.numpy().view(np.uint32), f"rank {r} {name}/{k}")


# (port argv, reference argv): the five flags the serve launcher took over
LAUNCH_FLAGS = {
    "requests-static": (["--requests", "3", "--prompt-len", "12", "--static"],
                        ["--requests", "3", "--prompt-len", "12", "--static"]),
    "chunks-mesh-static": (["--requests", "2", "--prompt-len", "8", "--chunks", "2",
                            "--static", "--mesh", "2x1"],
                           ["--requests", "2", "--prompt-len", "8", "--chunks", "2",
                            "--static"]),
    "contiguous": (["--requests", "3", "--prompt-len", "10", "--contiguous",
                    "--check-static"],
                   ["--requests", "3", "--prompt-len", "10", "--contiguous",
                    "--check-static"]),
}


def _streams(text):
    return re.findall(r"^  req(\d+): (\[.*\])$", text, re.M)


@pytest.mark.parametrize("case", list(LAUNCH_FLAGS))
def test_serve_launcher_new_flags_print_reference_streams(case, capsys):
    import repro.launch.serve as jlaunch
    from repro_torch.convert import convert_lm_params
    from repro_torch.launch import serve as tlaunch

    targv, jargv = LAUNCH_FLAGS[case]
    common = ["--arch", "qwen3-1.7b", "--reduced", "--gen", "4"]
    jcfg, tcfg = _lm_cfgs()  # both from the reference's seeded weights
    params, _ = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    tlaunch.main([*common, *targv, "--device", "cpu"],
                 params=convert_lm_params(tcfg, jax.tree_util.tree_map(np.asarray, params),
                                          device="cpu"))
    got = _streams(capsys.readouterr().out)
    buf, argv = io.StringIO(), sys.argv
    sys.argv = ["serve", *common, *jargv]
    try:
        with contextlib.redirect_stdout(buf):
            jlaunch.main()
    finally:
        sys.argv = argv
    want = _streams(buf.getvalue())
    assert got and got == want


def test_serve_launcher_layouts_are_exclusive(capsys):
    from repro_torch.launch import serve as tlaunch

    with pytest.raises(SystemExit):
        tlaunch.build_parser().parse_args(["--arch", "qwen3-1.7b", "--paged", "--contiguous"])
    args = tlaunch.build_parser().parse_args(["--arch", "qwen3-1.7b"])
    assert (args.requests, args.prompt_len, args.chunks, args.static) == (8, 64, None, False)
    assert tlaunch.prompt_lens(args) == [64] * 8


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
