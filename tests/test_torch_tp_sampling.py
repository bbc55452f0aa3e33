"""Sampled requests and int8 KV at tp 2: the port against the JAX
reference.

The reference's outputs come from one subprocess of this file (``python
tests/test_torch_tp_sampling.py INPUTS OUT``) with 2 emulated host
devices, at ``MeshCfg(tp=2, dp=1)`` (its engine cannot run on a mesh under
jax 0.9.0: ROADMAP "Reference caveats"), for three plans: sampled
requests (fp32 KV), greedy requests with ``int8_kv`` and sampled requests
with ``int8_kv``. Greedy runs call its ``generate_static``. Its sampled
``generate_static`` fails on a mesh under jax 0.9.0 (``ShardingTypeError``
in ``sample_tokens``' gather over the vocabulary-sharded logits), so the
sampled runs are ``generate_static``'s loop over the reference's own
``make_prefill_step`` / ``make_decode_step`` at the mesh and its
``sample_tokens`` on the gathered logits (:func:`_reference_static`). The port
runs as 2 gloo ranks (``spawn_ranks``, one CPU thread each): its static
run, its contiguous engine and its paged engine for each plan. Inputs:
reduced qwen3-1.7b with the reference's ``init_params(cfg, PRNGKey(0),
tp=2)`` weights converted, prompts 16, 12, 16, 8 from ``default_rng(0)``,
6 new tokens, sampling at temperature 0.8, top-p 0.95, top-k 40 and seeds
100 + i (request 3 at 2**32 - 1).

Exact: every stream of the port's static runs equals the reference's
``generate_static`` at the same mesh; every engine's equals the port's
static run; the streams are equal on both ranks. Then the launcher at
``--mesh 1x2`` with the sampling and int8 flags and ``--check-static``,
and a CPU rehearsal of ``chip_smoke.py`` phase 15.
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
LENS, GEN, SLOTS = (16, 12, 16, 8), 6, 2
SEEDS = (100, 101, 102, 2**32 - 1)
# (label, int8_kv, sampled)
PLANS = (("sampled", False, True), ("int8", True, False), ("int8-sampled", True, True))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _paths(tree):
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _inputs() -> dict:
    jcfg = j_reduced(j_get_config("qwen3-1.7b"))
    params, _ = j_init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    out = {f"w{k}": np.asarray(v) for k, v in _paths(params).items()}
    rng = np.random.default_rng(0)
    for i, S in enumerate(LENS):
        out[f"prompt{i}"] = rng.integers(0, jcfg.vocab_size, S).astype(np.int32)
    return out


def _params(inputs):
    jcfg = j_reduced(j_get_config("qwen3-1.7b"))
    shapes = jax.eval_shape(lambda k: j_init_params(jcfg, k, tp=TP)[0], jax.random.PRNGKey(0))
    flat = [inputs[f"w{k}"] for k in _paths(shapes)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), flat)


def _requests(inputs, request_cls, sampling_cls, sampled):
    return [request_cls(rid=i, prompt_ids=tuple(int(t) for t in inputs[f"prompt{i}"]),
                        max_new=GEN,
                        sampling=sampling_cls(0.8, 0.95, 40, seed=SEEDS[i]) if sampled
                        else None)
            for i in range(len(LENS))]


def _reference_static(cfg, mcfg, mesh, spec, storage, reqs, plan):
    """``repro.serve.engine.generate_static``'s loop (one batch a prompt
    length, scalar positions, the sampler a row each under the key-fold
    contract) on the reference's mesh steps, sampling from the logits
    gathered to the host."""
    import jax.numpy as jnp

    from repro.serve.sampling import sample_tokens
    from repro.serve.step import make_decode_step, make_prefill_step

    groups = {}
    for r in reqs:
        groups.setdefault(len(r.prompt_ids), []).append(r)
    out = {}
    for S, rs in groups.items():
        B = len(rs)
        prefill = make_prefill_step(cfg, mcfg, mesh, spec,
                                    {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)},
                                    plan=plan, cache_capacity=S + GEN, shard_batch=False)
        decode = make_decode_step(cfg, mcfg, mesh, spec,
                                  {"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32),
                                   "pos": jax.ShapeDtypeStruct((), jnp.int32)},
                                  plan=plan, shard_batch=False)
        rows = [r.sampling for r in rs]
        args = (np.asarray([p.temperature for p in rows], np.float32),
                np.asarray([p.top_p for p in rows], np.float32),
                np.asarray([p.top_k for p in rows], np.int32),
                np.asarray([p.seed for p in rows], np.uint32))

        def samp(logits, step):
            lg = jnp.asarray(np.asarray(logits))[:, -1]
            return np.asarray(sample_tokens(lg, cfg.vocab_size, *args,
                                            np.full((B,), step, np.int32)))

        logits, caches = prefill(storage, {"tokens": jnp.asarray([r.prompt_ids for r in rs],
                                                                 jnp.int32)})
        toks = [samp(logits, 0)]
        for i in range(GEN - 1):
            logits, caches = decode(storage, caches,
                                    {"tokens": jnp.asarray(toks[-1][:, None], jnp.int32),
                                     "pos": jnp.asarray(S + i, jnp.int32)})
            toks.append(samp(logits, i + 1))
        mat = np.stack(toks, axis=1)
        out.update({r.rid: mat[b].tolist() for b, r in enumerate(rs)})
    return out


def _reference(inputs_path, out_path):
    import jax.numpy as jnp

    from repro.dist.spec import MeshCfg as JMesh
    from repro.dist.spec import build_spec_tree, tree_to_storage
    from repro.launch.mesh import make_mesh_from_cfg
    from repro.plan import PrecisionPlan as JPlan
    from repro.plan import SamplingParams
    from repro.serve.engine import Request, generate_static

    inputs = dict(np.load(inputs_path))
    jcfg = j_reduced(j_get_config("qwen3-1.7b"))
    params = jax.tree_util.tree_map(jnp.asarray, _params(inputs))
    _, metas = j_init_params(jcfg, None, tp=TP)
    mcfg = JMesh(tp=TP, dp=1)
    mesh = make_mesh_from_cfg(mcfg)
    spec = build_spec_tree(params, metas, mcfg)
    storage = tree_to_storage(params, spec, mcfg)
    res = {}
    with mesh:
        for label, int8, sampled in PLANS:
            plan = JPlan.build(jcfg.num_groups + 1, round_to=2, int8_kv=int8)
            reqs = _requests(inputs, Request, SamplingParams, sampled)
            static = _reference_static if sampled else generate_static
            for rid, ids in static(jcfg, mcfg, mesh, spec, storage, reqs, plan=plan).items():
                res[f"{label}/{rid}"] = np.array(ids)
    np.savez(out_path, **res)


def _port_rank(rank, inputs):
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.convert import convert_lm_params
    from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_local, tree_to_storage
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.launch.serve import check_wire
    from repro_torch.models.init import init_params
    from repro_torch.plan import PrecisionPlan, SamplingParams
    from repro_torch.serve.engine import Request, ServeEngine, generate_static

    tcfg = reduced(get_config("qwen3-1.7b"))
    mcfg = MeshCfg(tp=TP, dp=1)
    mesh = make_mesh_from_cfg(mcfg)
    params = convert_lm_params(tcfg, _params(inputs), device="cpu", tp=TP)
    _, metas = init_params(tcfg, device="meta", tp=TP)
    spec = build_spec_tree(params, metas, mcfg)
    storage = tree_to_local(tree_to_storage(params, spec, mcfg), spec, mcfg, rank)
    out = {}
    for label, int8, sampled in PLANS:
        plan = PrecisionPlan.build(tcfg.num_groups + 1, round_to=2, int8_kv=int8)
        reqs = _requests(inputs, Request, SamplingParams, sampled)
        out[label, "static"] = generate_static(tcfg, mcfg, mesh, spec, storage, reqs, plan=plan)
        for paged in (False, True):
            eng = ServeEngine(tcfg, mcfg, mesh, spec, storage, plan=plan, max_slots=SLOTS,
                              cache_capacity=max(LENS) + GEN, paged=paged, page_size=8)
            res = eng.run(reqs)
            check_wire(eng, plan, reqs)
            out[label, "paged" if paged else "engine"] = {k: r.tokens for k, r in res.items()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_ranks

    tmp = tmp_path_factory.mktemp("tp_sampling")
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
        port = spawn_ranks(_port_rank, TP, inputs)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference failed:\n{stdout[-3000:]}\n{stderr[-3000:]}"
    ref = dict(np.load(out))
    return {label: {rid: ref[f"{label}/{rid}"].tolist() for rid in range(len(LENS))}
            for label, _, _ in PLANS}, port


@pytest.mark.parametrize("label", [p[0] for p in PLANS])
def test_static_streams_equal_reference_at_1x2(runs, label):
    ref, port = runs
    for r, p in enumerate(port):
        assert p[label, "static"] == ref[label], f"rank {r}"


@pytest.mark.parametrize("kind", ["engine", "paged"])
@pytest.mark.parametrize("label", [p[0] for p in PLANS])
def test_engines_equal_static_at_1x2(runs, label, kind):
    ref, port = runs
    for r, p in enumerate(port):
        assert p[label, kind] == p[label, "static"] == ref[label], f"rank {r}"
    assert port[0][label, kind] == port[1][label, kind]


def test_launcher_twin_at_1x2_with_sampling_and_int8(capsys):
    from repro_torch.launch import serve as launch

    results = launch.main(["--arch", "qwen3-1.7b", "--reduced", "--prompt-lens", "16,12,8",
                           "--gen", "4", "--max-slots", "2", "--mesh", "1x2",
                           "--temperature", "0.8", "--top-p", "0.95", "--top-k", "40",
                           "--seed", "100", "--int8-kv", "--check-static", "--device", "cpu"])
    assert sorted(results) == [0, 1, 2]
    out = capsys.readouterr().out
    assert "check-static: 3 streams equal to the static reference" in out
    assert "[OK against serve_wire_table]" in out


def test_chip_smoke_features_phase_rehearses_on_cpu(monkeypatch, capsys):
    """``chip_smoke.py`` phase 15 at reduced width on the CPU (plain
    versions; launch counts, memory and the sampler's card check are read
    on a card only), after a short phase 7 for its streams: (a)–(d) and the
    1×2 pair (e) pass their checks."""
    from repro_torch.configs.registry import get_config, reduced

    monkeypatch.syspath_prepend(ROOT)  # the spawned ranks import it by name
    import chip_smoke as smoke

    cpu = torch.device("cpu")
    served = smoke.serve_path(torch, cpu, cfg=reduced(get_config("qwen3-1.7b")),
                              lens=(24, 24, 16, 12, 8), gen=4)
    out = smoke.features_path(torch, cpu, served, gen=4, page=8, window=16)
    assert out["spec"]["self"]["acceptance_rate"] == 1.0
    assert out["spec"]["self paged"]["acceptance_rate"] == 1.0
    assert out["int8_rel"] < smoke.INT8_LOGIT_RTOL
    text = capsys.readouterr().out
    assert "(a): engine == static and paged == contiguous for all 5 sampled streams" in text
    assert "(e) 1×2" in text and "5 of 5 equal to one device's" in text
    assert "DIVERGED" not in text


if __name__ == "__main__":
    torch.set_num_threads(1)
    _reference(sys.argv[1], sys.argv[2])
