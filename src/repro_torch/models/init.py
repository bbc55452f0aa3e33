"""Parameter initialization + metadata for the LMs: attention, dense and
MoE, the recurrent families, vision cross-attention and the audio encoder
(counterpart of ``repro.models.init``).

``init_params(cfg, seed, device, tp)`` returns ``(params, metas)``, two
trees of the reference's structure: ``{"groups": [{"p0": {"attn": {...},
"mix": {...}}, "p1": ...}, ...], "embed", "head", "final_norm"}``, one
``p<i>`` per position of the block pattern, each position's leaves
stacked over its repetitions in the group (leading dim
``layers_per_group / len(pattern)``). An attention block (``attn`` or
``local``) has ``attn`` and a mixer ``mix``: the SwiGLU's ``w_gate`` /
``w_up`` / ``w_down`` (an ``audio`` arch's GeLU MLP: ``w_up`` /
``w_down``), or under ``num_experts`` the router ``(d, E)`` and
the experts' ``(E, d, ff)`` / ``(E, ff, d)`` leaves (with
``moe_dense_ff``, arctic's ``dense_*`` residual); ``qkv_bias`` adds
``bq`` / ``bk`` / ``bv``. A ``cross`` block has ``attn`` only, with a
0-d ``gate`` (zero, as the reference initialises it: ``tanh(0) = 0``, so
a fresh cross block adds nothing). Under the input stub the top level
has ``embed_in`` ``(vision_dim, d)`` instead of ``embed``; a VLM adds
``img_proj`` ``(vision_dim, d)``; both replicated and compressed
(``REPLICATED_BIG``). An ``mlstm`` block has ``mlstm``, an ``slstm``
block ``slstm`` (replicated over the model group), an ``rglru`` block
``rglru`` and a SwiGLU ``mix``; the RG-LRU's ``lam`` is the reference's
constant, drawn from ``np.random.default_rng(0)``. Shapes and metas
equal the reference's; the other values are drawn from one explicit
``torch.Generator`` seeded with ``seed`` on ``device``, leaf after leaf
(normal, std 0.02; output projections 0.02/sqrt(2L); norm scales ones,
biases zeros), so they are not the reference's ``jax.random`` draws (the
reference folds a key per layer and per mixer; one generator has no key
tree to keep in step with) — carry those across with
:func:`repro_torch.convert.convert_lm_params`. Shapes are global logical
at ``tp``: head counts and the vocabulary are padded up to TP
divisibility as in the reference (:func:`eff_heads`, :func:`eff_kv_heads`,
:func:`eff_vocab`), padded head rows and columns zero (qwen3-1.7b at tp 2
needs no padding).

``device="meta"`` gives the shapes without allocating anything.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.meta import REPLICATED_BIG, REPLICATED_SMALL, SEQ_NORM, ParamMeta
from repro_torch.utils.trees import round_up


def eff_heads(cfg: ModelConfig, tp: int) -> int:
    return round_up(cfg.num_heads, tp) if tp > 1 else cfg.num_heads


def eff_kv_heads(cfg: ModelConfig, tp: int) -> int:
    kv = cfg.num_kv_heads
    if tp > 1 and kv > tp and kv % tp:
        return round_up(kv, tp)
    return kv


def eff_vocab(cfg: ModelConfig, tp: int) -> int:
    return round_up(cfg.vocab_size, tp) if tp > 1 else cfg.vocab_size


class Maker:
    """Draws the leaves of one tree from one generator, in a fixed order."""

    def __init__(self, gen: torch.Generator | None, num_layers: int, device):
        self.gen = gen
        self.num_layers = num_layers
        self.device = torch.device(device)

    def normal(self, shape, scale=0.02):
        if self.device.type == "meta":
            return torch.empty(shape, device="meta")
        x = torch.empty(shape, dtype=torch.float32, device=self.device)
        return x.normal_(0.0, scale, generator=self.gen)

    def out_proj(self, shape):
        """Residual-branch output projection: 1/sqrt(2L)-scaled init."""
        return self.normal(shape, 0.02 / math.sqrt(2 * max(self.num_layers, 1)))

    def ones(self, shape):
        return torch.ones(shape, dtype=torch.float32, device=self.device)

    def zeros(self, shape):
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def const(self, values: np.ndarray):
        if self.device.type == "meta":
            return torch.empty(values.shape, device="meta")
        return torch.from_numpy(values.astype(np.float32)).to(self.device)

    def masked_heads(self, w, real_heads, padded_heads, hd, dim):
        """Zero the padded head rows/cols so that padding is inert."""
        if self.device.type == "meta" or real_heads == padded_heads:
            return w
        keep = torch.arange(w.shape[dim], device=w.device) < real_heads * hd
        return w * (keep[None, :] if dim == 1 else keep[:, None]).to(w.dtype)


def _attn_params(mk: Maker, cfg: ModelConfig, tp: int, is_cross: bool = False):
    d, hd = cfg.d_model, cfg.head_dim
    H, Kv = eff_heads(cfg, tp), eff_kv_heads(cfg, tp)
    p = {
        "wq": mk.masked_heads(mk.normal((d, H * hd)), cfg.num_heads, H, hd, 1),
        "wk": mk.normal((d, Kv * hd)),
        "wv": mk.normal((d, Kv * hd)),
        "wo": mk.masked_heads(mk.out_proj((H * hd, d)), cfg.num_heads, H, hd, 0),
        "ln": mk.ones((d,)),
    }
    m = {
        "wq": ParamMeta(tp_dim=1, tp_units=H),
        "wk": ParamMeta(tp_dim=1, tp_units=Kv),
        "wv": ParamMeta(tp_dim=1, tp_units=Kv),
        "wo": ParamMeta(tp_dim=0, tp_units=H),
        "ln": SEQ_NORM,
    }
    if cfg.qkv_bias:
        p["bq"] = mk.zeros((H * hd,))
        p["bk"] = mk.zeros((Kv * hd,))
        p["bv"] = mk.zeros((Kv * hd,))
        m["bq"] = ParamMeta(tp_dim=0, tp_units=H, compress=False)
        m["bk"] = ParamMeta(tp_dim=0, tp_units=Kv, compress=False)
        m["bv"] = ParamMeta(tp_dim=0, tp_units=Kv, compress=False)
    if cfg.qk_norm:
        p["q_norm"] = mk.ones((hd,))
        p["k_norm"] = mk.ones((hd,))
        m["q_norm"] = ParamMeta(tp_dim=None, compress=False, grad_sync_model=True)
        m["k_norm"] = ParamMeta(tp_dim=None, compress=False, grad_sync_model=True)
    if is_cross:
        p["gate"] = mk.zeros(())
        m["gate"] = ParamMeta(tp_dim=None, compress=False, grad_sync_model=True)
    return p, m


def _mlp_params(mk: Maker, cfg: ModelConfig, audio: bool = False):
    d, ff = cfg.d_model, cfg.d_ff
    if audio:
        p = {
            "ln": mk.ones((d,)),
            "w_up": mk.normal((d, ff)),
            "w_down": mk.out_proj((ff, d)),
        }
        m = {
            "ln": SEQ_NORM,
            "w_up": ParamMeta(tp_dim=1),
            "w_down": ParamMeta(tp_dim=0),
        }
        return p, m
    p = {
        "ln": mk.ones((d,)),
        "w_gate": mk.normal((d, ff)),
        "w_up": mk.normal((d, ff)),
        "w_down": mk.out_proj((ff, d)),
    }
    m = {
        "ln": SEQ_NORM,
        "w_gate": ParamMeta(tp_dim=1),
        "w_up": ParamMeta(tp_dim=1),
        "w_down": ParamMeta(tp_dim=0),
    }
    return p, m


def _moe_params(mk: Maker, cfg: ModelConfig):
    """Router, experts and (arctic) the dense residual. The ``tp`` layout
    slices every expert's ``d_ff`` over the model group; ``ep`` gives each
    model rank ``E / tp`` whole experts."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    if cfg.moe_impl == "ep":
        gate_meta = ParamMeta(tp_dim=0, tp_units=E)
        down_meta = ParamMeta(tp_dim=0, tp_units=E)
    else:
        gate_meta = ParamMeta(tp_dim=2)
        down_meta = ParamMeta(tp_dim=1)
    p = {
        "ln": mk.ones((d,)),
        "router": mk.normal((d, E)),
        "w_gate": mk.normal((E, d, ff)),
        "w_up": mk.normal((E, d, ff)),
        "w_down": mk.out_proj((E, ff, d)),
    }
    m = {
        "ln": SEQ_NORM,
        "router": ParamMeta(tp_dim=None, compress=d * E >= 65536, grad_sync_model=True),
        "w_gate": gate_meta,
        "w_up": gate_meta,
        "w_down": down_meta,
    }
    if cfg.moe_dense_ff:
        dff = cfg.moe_dense_ff
        p["dense_gate"] = mk.normal((d, dff))
        p["dense_up"] = mk.normal((d, dff))
        p["dense_down"] = mk.out_proj((dff, d))
        m["dense_gate"] = ParamMeta(tp_dim=1)
        m["dense_up"] = ParamMeta(tp_dim=1)
        m["dense_down"] = ParamMeta(tp_dim=0)
    return p, m


def _mlstm_params(mk: Maker, cfg: ModelConfig):
    d = cfg.d_model
    dv = int(cfg.mlstm_proj_factor * d)
    H = cfg.num_heads
    p = {
        "ln": mk.ones((d,)),
        "wq": mk.normal((d, dv)),
        "wk": mk.normal((d, dv)),
        "wv": mk.normal((d, dv)),
        "wi": mk.normal((d, H)),
        "wf": mk.normal((d, H)),
        "wog": mk.normal((d, dv)),
        "w_down": mk.out_proj((dv, d)),
    }
    m = {
        "ln": SEQ_NORM,
        "wq": ParamMeta(tp_dim=None, grad_sync_model=True),  # full keys on every rank
        "wk": ParamMeta(tp_dim=None, grad_sync_model=True),
        "wv": ParamMeta(tp_dim=1),
        "wi": ParamMeta(tp_dim=None, compress=False, grad_sync_model=True),
        "wf": ParamMeta(tp_dim=None, compress=False, grad_sync_model=True),
        "wog": ParamMeta(tp_dim=1),
        "w_down": ParamMeta(tp_dim=0),
    }
    return p, m


def _slstm_params(mk: Maker, cfg: ModelConfig):
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    p = {
        "ln": mk.ones((d,)),
        "w_in": mk.normal((d, 4 * d)),
        "r": mk.normal((H, dh, 4 * dh)),
        "b": mk.zeros((4 * d,)),
        "w_out": mk.out_proj((d, d)),
    }
    m = {
        "ln": REPLICATED_SMALL,
        "w_in": REPLICATED_BIG,
        "r": REPLICATED_BIG,
        "b": REPLICATED_SMALL,
        "w_out": REPLICATED_BIG,
    }
    return p, m


def rglru_lambda(r: int) -> np.ndarray:
    """The reference's Λ init, so that a ∈ (0.9, 0.999) at r_gate ≈ 0.5
    (Griffin appendix), from its own seeded generator."""
    a = np.random.default_rng(0).uniform(0.9, 0.999, r)
    return np.log(np.expm1(-np.log(a) / (0.5 * 8.0))).astype(np.float32)


def _rglru_params(mk: Maker, cfg: ModelConfig):
    d = cfg.d_model
    r = cfg.lru_dim or d
    W = cfg.conv1d_width
    p = {
        "ln": mk.ones((d,)),
        "w_x": mk.normal((d, r)),
        "w_y": mk.normal((d, r)),
        "conv_w": mk.normal((W, r)),
        "conv_b": mk.zeros((r,)),
        "w_a": mk.normal((d, r)),
        "b_a": mk.zeros((r,)),
        "w_i": mk.normal((d, r)),
        "b_i": mk.zeros((r,)),
        "lam": mk.const(rglru_lambda(r)),
        "w_down": mk.out_proj((r, d)),
    }
    m = {
        "ln": SEQ_NORM,
        "w_x": ParamMeta(tp_dim=1),
        "w_y": ParamMeta(tp_dim=1),
        "conv_w": ParamMeta(tp_dim=1, compress=False),
        "conv_b": ParamMeta(tp_dim=0, compress=False),
        "w_a": ParamMeta(tp_dim=1),
        "b_a": ParamMeta(tp_dim=0, compress=False),
        "w_i": ParamMeta(tp_dim=1),
        "b_i": ParamMeta(tp_dim=0, compress=False),
        "lam": ParamMeta(tp_dim=0, compress=False),
        "w_down": ParamMeta(tp_dim=0),
    }
    return p, m


def _block_params(mk: Maker, kind: str, cfg: ModelConfig, tp: int):
    """(params, metas) of one block of the pattern kind ``kind``."""
    if kind in ("attn", "local", "cross"):
        pa, ma = _attn_params(mk, cfg, tp, is_cross=kind == "cross")
        p, m = {"attn": pa}, {"attn": ma}
        if kind == "cross":  # no channel mixer
            return p, m
        if cfg.num_experts:
            p["mix"], m["mix"] = _moe_params(mk, cfg)
        elif cfg.d_ff:
            p["mix"], m["mix"] = _mlp_params(mk, cfg, audio=cfg.arch_type == "audio")
        return p, m
    if kind == "mlstm":
        p, m = _mlstm_params(mk, cfg)
    elif kind == "slstm":
        p, m = _slstm_params(mk, cfg)
    elif kind == "rglru":
        pr, mr = _rglru_params(mk, cfg)
        pc, mc = _mlp_params(mk, cfg)
        return {"rglru": pr, "mix": pc}, {"rglru": mr, "mix": mc}
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return {kind: p}, {kind: m}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees, dim=0)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", tp: int = 1):
    """Global-logical ``(params, metas)`` at ``tp``, layers stacked per
    precision group (see the module docstring)."""
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    mk = Maker(gen, cfg.num_layers, device)
    pat = cfg.pattern
    reps = cfg.layers_per_group // len(pat)
    groups_p, groups_m = [], []
    for _ in range(cfg.num_groups):
        stacks, metas = [[] for _ in pat], [None] * len(pat)
        for _ in range(reps):
            for pi, kind in enumerate(pat):
                p, metas[pi] = _block_params(mk, kind, cfg, tp)
                stacks[pi].append(p)
        groups_p.append({f"p{pi}": _stack(s) for pi, s in enumerate(stacks)})
        groups_m.append({f"p{pi}": m for pi, m in enumerate(metas)})

    d, V = cfg.d_model, eff_vocab(cfg, tp)
    params, metas = {"groups": groups_p}, {"groups": groups_m}
    if cfg.embed_is_input_stub:
        params["embed_in"] = mk.normal((cfg.vision_dim, d))
        metas["embed_in"] = REPLICATED_BIG
    else:
        params["embed"] = mk.normal((V, d))
        metas["embed"] = ParamMeta(tp_dim=0, tp_units=V)
    if not cfg.tie_embeddings:
        params["head"] = mk.normal((d, V))
        metas["head"] = ParamMeta(tp_dim=1, tp_units=V)
    if cfg.num_image_tokens:
        params["img_proj"] = mk.normal((cfg.vision_dim, d))
        metas["img_proj"] = REPLICATED_BIG
    params["final_norm"] = mk.ones((d,))
    metas["final_norm"] = SEQ_NORM
    return params, metas


def param_shapes(cfg: ModelConfig, tp: int = 1):
    """``(params, metas)`` with every leaf a ``meta``-device tensor: the
    shapes and dtypes of :func:`init_params` at ``tp``, nothing allocated
    (the reference's abstract ``ShapeDtypeStruct`` tree)."""
    return init_params(cfg, device="meta", tp=tp)
