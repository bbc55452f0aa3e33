"""The MoE channel mixer (``repro_torch.models.moe``) against the JAX
reference (``repro.models.moe``).

Inputs are numpy from seeds; weights are drawn here and given to both
packages as they are. Routing in one process:

  * ``_route``'s experts (top-k, ties to the lower index, also under forced
    ties) and ``_dispatch_indices``' four outputs (the stable sort, the
    ranks against capacity, the trash slot at ``E·C``) equal the
    reference's exactly; ``capacity`` equals the reference's formula. The
    router probabilities and the aux loss are within 1e-6 (rtol 1e-6 for
    the aux): XLA's ``exp`` and PyTorch's differ by an ulp, so fp32
    softmax values are not bit-equal across the packages, while every
    routing decision in these cases is.
  * ``moe_block`` in the ``tp`` layout (one device), with and without
    arctic's dense residual, with capacity drops and without: the output
    within atol 2e-6 / rtol 1e-5, the aux within rtol 1e-6, and the
    gradients of ``Σ y·c + aux`` with respect to the input and every
    weight within atol 5e-6 / rtol 5e-4 of ``jax.grad``'s.

The ``ep`` layout at tp 2: the reference in one subprocess of this file
(``python tests/test_torch_moe.py INPUTS OUT``, 2 emulated host devices)
runs ``moe_block`` inside ``shard_map`` over a 2-device model axis; the
port in 2 gloo ranks (``spawn_ranks``, one CPU thread each), each on its
experts and its slices of the dense residual. Cases: the token split
(``ep_split``, arctic's reduced config: 4 experts, 2 a rank, the dense
residual; and mixtral's reduced config switched to ``ep``, no residual),
replicated EP (decode: ``B·S`` of 1 and of 3, which do not split over 2
ranks) and the sequence-parallel layout (the shards are the token split).
Each rank's output, aux and gradients (input, router, its experts, its
dense slices) are held to the reference's device of the same rank: output
atol 2e-6, aux rtol 1e-6, gradients atol 5e-6 / rtol 5e-4 (input gradients
are O(1), sums of 512 fp32 terms in another order; the router's sum over
the tokens, seen 1.7e-4 relative). The reference's MoE gradients at tp > 1
are repaired in its process first (ROADMAP Queue 3), its forward
untouched. Its ``psum_enter`` before the token split sums a cotangent that
the split's backward has already gathered whole; replicated EP sums ``tp``
whole copies of the expert branch; and every model rank takes the aux's
whole cotangent, which the router's gradient sync then sums. Each gives
``tp`` times the one-device gradient. The repair divides by ``tp`` the
cotangent of the split's input, of a replicated copy's expert branch and
of the aux. The port makes none of these faults, which the one-device
tests show on their own: at a capacity that drops nothing, each rank's
gradients of ``Σ y·c`` (input; router summed over the ranks, as the
gradient sync does; its experts; its dense slices) equal the port's
one-device ``tp`` layout's, and the aux's gradients, in both layouts,
equal those of the same aux on one device, within the same tolerances.
The port's split, merge and exchanges are logged as ``relayout`` and the
aux sum as ``metrics``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.models import moe as jm
from repro.models.env import Env as JEnv
from repro_torch.configs.registry import get_config, reduced
from repro_torch.models import moe as tm
from repro_torch.models.env import Env

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TP = 2
P_ATOL = 1e-6
AUX_RTOL = 1e-6
Y_TOL = dict(atol=2e-6, rtol=1e-5)
GRAD_TOL = dict(atol=5e-6, rtol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _weights(cfg, seed):
    """numpy MoE weights of one layer (no norm scale), from a seed."""
    rng = np.random.default_rng(seed)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.d_ff

    def normal(*shape, s=0.05):
        return rng.normal(0, s, shape).astype(np.float32)

    w = {"router": normal(d, E, s=0.2), "w_gate": normal(E, d, ff),
         "w_up": normal(E, d, ff), "w_down": normal(E, ff, d)}
    if cfg.moe_dense_ff:
        f = cfg.moe_dense_ff
        w.update(dense_gate=normal(d, f), dense_up=normal(d, f), dense_down=normal(f, d))
    return w


# ---------------------------------------------------------------------------
# routing, in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,d,E,k", [(64, 256, 4, 2), (300, 256, 8, 2), (17, 64, 128, 2),
                                     (40, 32, 4, 1), (9, 32, 8, 3)])
def test_route_matches_reference(T, d, E, k):
    rng = np.random.default_rng(T)
    x = rng.normal(size=(T, d)).astype(np.float32)
    w = (rng.normal(size=(d, E)) * 0.05).astype(np.float32)
    jp, je, ja = jm._route(jnp.asarray(x), jnp.asarray(w), E, k)
    tp, te, ta = tm._route(torch.from_numpy(x), torch.from_numpy(w), E, k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=P_ATOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=AUX_RTOL)


def test_route_ties_break_to_the_lower_expert():
    """Router columns repeated, so that probabilities tie exactly in both
    packages: the experts are the reference's, the lower index first, as
    ``lax.top_k`` breaks ties (``torch.topk`` makes no such promise)."""
    rng = np.random.default_rng(1)
    base = rng.normal(size=(32, 3)).astype(np.float32)
    w = base[:, [0, 1, 0, 2, 1, 0, 2, 2]]  # 8 experts, each column thrice or twice
    x = rng.normal(size=(50, 32)).astype(np.float32)
    x[:10] = 0.0  # every expert ties on these rows
    for k in (1, 2, 3):
        jp, je, _ = jm._route(jnp.asarray(x), jnp.asarray(w), 8, k)
        tp, te, _ = tm._route(torch.from_numpy(x), torch.from_numpy(w), 8, k)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(te[:10].numpy(), np.tile(np.arange(k), (10, 1)))
        probs = torch.softmax(torch.from_numpy(x @ w), -1)
        for t in range(50):  # equal probabilities come in increasing expert order
            row = te[t].tolist()
            for a, b in zip(row, row[1:]):
                assert probs[t, a] > probs[t, b] or a < b, (t, row)


@pytest.mark.parametrize("case", ["fits", "overflow", "one-expert", "top1", "top3"])
def test_dispatch_indices_bit_equal(case):
    rng = np.random.default_rng(7)
    T, E, k, cap = {"fits": (40, 4, 2, 32), "overflow": (40, 4, 2, 8),
                    "one-expert": (24, 4, 2, 8), "top1": (40, 4, 1, 8),
                    "top3": (24, 4, 3, 8)}[case]
    top_e = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    if case == "one-expert":
        top_e[:, 0] = 2
        top_e[:, 1] = rng.choice([0, 1, 3], T)
    jout = jm._dispatch_indices(jnp.asarray(top_e), E, cap)
    tout = tm._dispatch_indices(torch.from_numpy(top_e).to(torch.int64), E, cap)
    for name, j, t in zip(("src", "dest", "keep", "order"), jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    kept = tout[2].numpy()
    assert (case == "fits") == bool(kept.all())
    assert (tout[1].numpy()[~kept] == E * cap).all()


@pytest.mark.parametrize("tokens", [1, 2, 7, 64, 1024, 4096])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
def test_capacity_matches_reference(arch, tokens):
    """``max(8, round_up(int(cf·T·k/E), 8))``, full-width configs."""
    from repro.utils.trees import round_up

    j = j_get_config(arch)
    want = max(8, round_up(int(j.capacity_factor * tokens * j.top_k / j.num_experts), 8))
    assert tm.capacity(get_config(arch), tokens) == want


# ---------------------------------------------------------------------------
# moe_block, tp layout (one device)
# ---------------------------------------------------------------------------


def _jax_block(cfg, w, x, cot, env=None):
    """(y, aux, grads {"x": .., weight: ..}) of the reference's moe_block."""
    def loss(x, w):
        y, aux = jm.moe_block(x, w, cfg, env or JEnv())
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (y, aux)), (gx, gw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, w))
    return np.asarray(y), float(aux), {"x": np.asarray(gx), **{k: np.asarray(v)
                                                               for k, v in gw.items()}}


def _torch_block(cfg, w, x, cot, env=None, with_aux=True):
    """The port's (y, aux, grads) of ``Σ y·cot + aux`` (without ``aux``
    when not ``with_aux``)."""
    tw = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in w.items()}
    tx = torch.from_numpy(np.array(x)).requires_grad_(True)
    y, aux = tm.moe_block(tx, tw, cfg, env or Env())
    (torch.sum(y * torch.from_numpy(np.array(cot))) + (aux if with_aux else 0.0)).backward()
    return (y.detach().numpy(), float(aux.detach()),
            {"x": tx.grad.numpy(), **{k: v.grad.numpy() for k, v in tw.items()}})


@pytest.mark.parametrize("arch,cf", [("mixtral-8x7b", 1.25), ("mixtral-8x7b", 0.5),
                                     ("arctic-480b", 1.25), ("arctic-480b", 0.5)],
                         ids=["mixtral", "mixtral-drops", "arctic-dense", "arctic-drops"])
def test_moe_block_tp_layout_matches_reference(arch, cf):
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    w = _weights(jcfg, 3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    jy, ja, jg = _jax_block(jcfg, w, x, cot)
    ty, ta, tg = _torch_block(tcfg, w, x, cot)
    np.testing.assert_allclose(ty, jy, **Y_TOL)
    np.testing.assert_allclose(ta, ja, rtol=AUX_RTOL)
    assert set(tg) == set(jg) == {"x", *w}
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **GRAD_TOL)
    T = x.shape[0] * x.shape[1]
    _, te, _ = tm._route(torch.from_numpy(x.reshape(T, -1)), torch.from_numpy(w["router"]),
                         tcfg.num_experts, tcfg.top_k)
    _, _, keep, _ = tm._dispatch_indices(te, tcfg.num_experts, tm.capacity(tcfg, T))
    assert bool(keep.all()) == (cf > 1)  # the drop cases drop


# ---------------------------------------------------------------------------
# the ep layout at tp 2
# ---------------------------------------------------------------------------

# (label, arch, overrides, (B, S) of the global input, seq_parallel)
EP_CASES = (
    ("split", "arctic-480b", {}, (2, 8), False),
    ("split-nodense", "mixtral-8x7b", {"moe_impl": "ep"}, (2, 8), False),
    ("decode", "arctic-480b", {}, (1, 1), False),
    ("decode3", "arctic-480b", {}, (3, 1), False),
    ("seq", "arctic-480b", {}, (2, 8), True),
)
EP_NODROP = 4.0  # the capacity factor of the one-device comparison (drops nothing)


def _ep_inputs() -> dict:
    out = {}
    for i, (label, arch, kw, (B, S), _) in enumerate(EP_CASES):
        jcfg, _ = _cfgs(arch, **kw)
        for k, v in _weights(jcfg, 10 + i).items():
            out[f"{label}/w/{k}"] = v
        rng = np.random.default_rng(20 + i)
        out[f"{label}/x"] = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
        out[f"{label}/cot"] = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    return out


def _case_weights(inputs, label):
    return {k.split("/", 2)[2]: v for k, v in inputs.items() if k.startswith(f"{label}/w/")}


def _rank_slice(name, v, m):
    """Model rank ``m``'s slice of a weight in the ep layout: whole experts
    (dim 0), the dense residual's d_ff (columns of gate / up, rows of
    down); the router whole."""
    if name == "router":
        return v
    if name in ("dense_gate", "dense_up"):
        half = v.shape[1] // TP
        return v[:, m * half:(m + 1) * half]
    half = v.shape[0] // TP
    return v[m * half:(m + 1) * half]


def _share_cotangent(tp):
    """Identity whose backward divides the cotangent by ``tp``."""
    @jax.custom_vjp
    def share(x):
        return x

    share.defvjp(lambda x: (x, None), lambda _, g: (g / tp,))
    return share


def repair_reference(tp):
    """The reference's MoE gradients at tp > 1 made the port's (ROADMAP
    Queue 3), its forward unchanged: the cotangent of ``_token_split``'s
    input is divided by ``tp`` (the ``psum_enter`` before it then sums
    ``tp`` shares of the whole cotangent back to one, as if it were not
    there), and so is that of ``_route``'s aux (every model rank's aux
    takes its share). For this file's reference process and
    ``tests/test_torch_moe_mesh.py``'s."""
    split, route, share = jm._token_split, jm._route, _share_cotangent(tp)

    def shared_route(*a):
        p, e, aux = route(*a)
        return p, e, share(aux)

    jm._token_split = lambda x, axis: split(share(x), axis)
    jm._route = shared_route


@contextlib.contextmanager
def _repair_reference_replicated(tp):
    """Replicated EP runs the experts' work once per rank: each rank's copy
    takes ``1 / tp`` of the expert branch's cotangent (at the experts'
    output and at the router's top probabilities, the two factors of its
    combine), as the port's copy does. Forward unchanged."""
    ffn, route, share = jm._expert_ffn, jm._route, _share_cotangent(tp)

    def shared_route(*a):
        p, e, aux = route(*a)
        return share(p), e, aux

    jm._expert_ffn, jm._route = (lambda *a: share(ffn(*a))), shared_route
    try:
        yield
    finally:
        jm._expert_ffn, jm._route = ffn, route


def _reference(inputs_path, out_path):
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.dist.shard import shard_map

    repair_reference(TP)
    inputs = dict(np.load(inputs_path))
    mesh = Mesh(np.array(jax.devices()[:TP]), ("model",))
    res = {}
    for label, arch, kw, (B, S), sp in EP_CASES:
        jcfg, _ = _cfgs(arch, **kw)
        w = {k: jnp.asarray(v) for k, v in _case_weights(inputs, label).items()}
        x, cot = jnp.asarray(inputs[f"{label}/x"]), jnp.asarray(inputs[f"{label}/cot"])
        seqd = P(None, "model", None)
        wspec = {k: P() if k == "router" else P(None, "model") if k in ("dense_gate", "dense_up")
                 else P("model") for k in w}
        replicated = not sp and (B * S % TP or B * S < TP)

        def body(x, cot, w):
            env = JEnv(model_axis="model", tp=TP, seq_parallel=sp)

            def loss(x, w):
                y, aux = jm.moe_block(x, w, jcfg, env)
                return jnp.sum(y * cot) + aux, (y, aux)

            (_, (y, aux)), (gx, gw) = jax.value_and_grad(loss, argnums=(0, 1),
                                                         has_aux=True)(x, w)
            return {"y": y[None], "aux": aux[None], "x": gx[None],
                    **{k: v[None] for k, v in gw.items()}}

        xs = seqd if sp else P()
        fn = shard_map(body, mesh=mesh, in_specs=(xs, xs, wspec),
                       out_specs={k: P("model") for k in ("y", "aux", "x", *w)})
        with _repair_reference_replicated(TP) if replicated else contextlib.nullcontext():
            got = jax.jit(fn)(x, cot, w)
        for k, v in got.items():
            res[f"{label}/{k}"] = np.asarray(v)
    np.savez(out_path, **res)


def _port_rank(rank, inputs):
    from repro_torch.dist import comm
    from repro_torch.dist.spec import MeshCfg
    from repro_torch.launch.mesh import make_mesh_from_cfg

    mesh = make_mesh_from_cfg(MeshCfg(tp=TP))
    out = {}
    for label, arch, kw, (B, S), sp in EP_CASES:
        _, tcfg = _cfgs(arch, **kw)
        env = Env(model_group=mesh.model, tp=TP, seq_parallel=sp)
        w = {k: _rank_slice(k, v, rank) for k, v in _case_weights(inputs, label).items()}
        x, cot = inputs[f"{label}/x"], inputs[f"{label}/cot"]
        if sp:
            half = S // TP
            x, cot = x[:, rank * half:(rank + 1) * half], cot[:, rank * half:(rank + 1) * half]
        first = len(comm.LOG)
        y, aux, g = _torch_block(tcfg, w, x, cot, env)
        out[f"{label}/y"], out[f"{label}/aux"] = y, aux
        out.update({f"{label}/{k}": v for k, v in g.items()})
        out[f"{label}/log"] = [(r.kind, r.traffic) for r in comm.LOG[first:]]
        # the gradients of Σ y·c at a capacity that drops nothing
        nodrop = dataclasses.replace(tcfg, capacity_factor=EP_NODROP)
        y, _, g = _torch_block(nodrop, w, x, cot, env, with_aux=False)
        out[f"{label}/nodrop/y"] = y
        out.update({f"{label}/nodrop/{k}": v for k, v in g.items()})
        # the aux's own gradients (a zero cotangent on y)
        g = _torch_block(tcfg, w, x, np.zeros_like(cot), env)[2]
        out[f"{label}/auxgrad/x"], out[f"{label}/auxgrad/router"] = g["x"], g["router"]
    # the tp layout's aux gradients: mixtral's experts, d_ff split over the ranks
    _, tcfg = _cfgs("mixtral-8x7b")
    w = _case_weights(inputs, "split-nodense")
    f = tcfg.d_ff // TP
    own = slice(rank * f, (rank + 1) * f)
    w = {"router": w["router"], "w_gate": w["w_gate"][:, :, own], "w_up": w["w_up"][:, :, own],
         "w_down": w["w_down"][:, own]}
    x = inputs["split-nodense/x"]
    g = _torch_block(tcfg, w, x, np.zeros_like(x), Env(model_group=mesh.model, tp=TP))[2]
    out["tp/auxgrad/x"], out["tp/auxgrad/router"] = g["x"], g["router"]
    return out


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """(reference outputs, [per-rank port outputs], inputs)."""
    from repro_torch.launch.mesh import spawn_ranks

    tmp = tmp_path_factory.mktemp("moe_ep")
    inputs = _ep_inputs()
    inp, out = str(tmp / "inputs.npz"), str(tmp / "ref.npz")
    np.savez(inp, **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={TP}"
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
    return dict(np.load(out)), port, inputs


@pytest.mark.parametrize("label", [c[0] for c in EP_CASES])
def test_ep_layout_matches_reference(ep_runs, label):
    """Forward and gradients of every rank against the reference's device
    of the same rank (the module docstring's tolerances)."""
    ref, port, inputs = ep_runs
    names = ["x", *_case_weights(inputs, label)]
    for m, p in enumerate(port):
        np.testing.assert_allclose(p[f"{label}/y"], ref[f"{label}/y"][m], **Y_TOL)
        np.testing.assert_allclose(p[f"{label}/aux"], ref[f"{label}/aux"][m], rtol=AUX_RTOL)
        for k in names:  # each device's own (local) gradient, stacked by rank
            np.testing.assert_allclose(p[f"{label}/{k}"], ref[f"{label}/{k}"][m],
                                       err_msg=f"rank {m} {k}", **GRAD_TOL)


@pytest.mark.parametrize("label", [c[0] for c in EP_CASES])
def test_ep_collectives_are_logged_as_relayout_and_metrics(ep_runs, label):
    """Forward and backward: the split's gather, the merge's gather, the
    two expert exchanges each way as ``relayout``; the aux sum (split and
    seq-parallel only) and its backward as ``metrics``; the dense
    residual's boundaries as ``activations`` / ``seq_boundary``."""
    _, port, _ = ep_runs
    spec = {c[0]: c for c in EP_CASES}[label]
    split, dense, sp = label in ("split", "split-nodense"), spec[1] == "arctic-480b", spec[4]
    for p in port:
        log = p[f"{label}/log"]
        count = lambda kind, traffic: sum(r == (kind, traffic) for r in log)  # noqa: E731
        assert count("all-to-all", "relayout") == 4
        assert count("all-gather", "relayout") == (2 if split else 0)
        assert count("all-reduce", "metrics") == (2 if split or sp else 0)
        if sp:
            assert {t for _, t in log} == {"relayout", "metrics"} | ({"seq_boundary"} if dense
                                                                     else set())
        else:
            # the dense exit forward and its enter; replicated EP's
            # psum_enter backward (the split has none)
            assert count("all-reduce", "activations") == (0 if split else 1) + dense * 2


@pytest.mark.parametrize("label", [c[0] for c in EP_CASES])
def test_ep_layout_gradients_match_one_device(ep_runs, label):
    """The ``ep`` layout's gradients are the one-device ones: at a capacity
    that drops nothing, where the forward is the same, each rank's output
    and gradients of ``Σ y·c`` (without the aux: that of a token chunk is
    not the whole batch's) against the port's one-device ``tp`` layout.
    Each rank holds the whole input gradient (its sequence shard under the
    sequence-parallel layout), its experts' and its dense slices'; the
    router's, partial on a rank, summed over the ranks as the gradient
    sync sums it."""
    _, port, inputs = ep_runs
    _, arch, kw, (B, S), sp = {c[0]: c for c in EP_CASES}[label]
    _, tcfg = _cfgs(arch, **{**kw, "capacity_factor": EP_NODROP})
    w = _case_weights(inputs, label)
    one_y, _, one_g = _torch_block(tcfg, w, inputs[f"{label}/x"], inputs[f"{label}/cot"],
                                   with_aux=False)
    half = S // TP
    for m, p in enumerate(port):
        own = (slice(None), slice(m * half, (m + 1) * half)) if sp else ...
        np.testing.assert_allclose(p[f"{label}/nodrop/y"], one_y[own], **Y_TOL)
        np.testing.assert_allclose(p[f"{label}/nodrop/x"], one_g["x"][own], err_msg=f"rank {m} x",
                                   **GRAD_TOL)
        for k in w:
            if k != "router":
                np.testing.assert_allclose(p[f"{label}/nodrop/{k}"], _rank_slice(k, one_g[k], m),
                                           err_msg=f"rank {m} {k}", **GRAD_TOL)
    np.testing.assert_allclose(sum(p[f"{label}/nodrop/router"] for p in port), one_g["router"],
                               err_msg="router", **GRAD_TOL)


def _one_device_aux_grads(w, x, cfg, chunks):
    """Gradients (input, router) of the mean over ``chunks(x)`` of each
    token chunk's aux, on one device."""
    tx = torch.from_numpy(np.array(x)).requires_grad_(True)
    tr = torch.from_numpy(np.array(w["router"])).requires_grad_(True)
    auxes = [tm._route(c.reshape(-1, x.shape[-1]), tr, cfg.num_experts, cfg.top_k)[2]
             for c in chunks(tx)]
    (sum(auxes) / len(auxes)).backward()
    return tx.grad.numpy(), tr.grad.numpy()


@pytest.mark.parametrize("label", [c[0] for c in EP_CASES] + ["tp"])
def test_aux_gradients_match_one_device(ep_runs, label):
    """At tp 2 the aux loss is the one-device aux of the rank's tokens,
    averaged over the ranks (the split's and the sequence shards' chunks)
    or whole (replicated EP, and the ``tp`` layout, which routes every
    token on every rank); its gradients are that function's on one device:
    the input's on each rank (its shard under the sequence-parallel
    layout), the router's summed over the ranks. Atol 5e-6 / rtol 5e-4.
    Each model rank computes the aux, so each takes ``1 / tp`` of its
    cotangent; without that these come out ``tp`` times too large, as in
    the reference."""
    _, port, inputs = ep_runs
    spec = {c[0]: c for c in EP_CASES}.get(label, ("tp", "mixtral-8x7b", {}, (2, 8), False))
    _, arch, kw, (B, S), sp = spec
    case = "split-nodense" if label == "tp" else label
    _, tcfg = _cfgs(arch, **kw)
    split = label in ("split", "split-nodense")
    chunks = (lambda t: t.reshape(B * S, -1).chunk(TP)) if split else \
        (lambda t: t.chunk(TP, dim=1)) if sp else (lambda t: [t])
    gx, gr = _one_device_aux_grads(_case_weights(inputs, case), inputs[f"{case}/x"], tcfg,
                                   chunks)
    half = S // TP
    for m, p in enumerate(port):
        own = (slice(None), slice(m * half, (m + 1) * half)) if sp else ...
        np.testing.assert_allclose(p[f"{label}/auxgrad/x"], gx[own], err_msg=f"rank {m} x",
                                   **GRAD_TOL)
    np.testing.assert_allclose(sum(p[f"{label}/auxgrad/router"] for p in port), gr,
                               err_msg="router", **GRAD_TOL)


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
