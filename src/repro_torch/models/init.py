"""Parameter initialization + metadata for the dense LM (counterpart of
``repro.models.init``, the ``attn`` pattern).

``init_params(cfg, seed, device, tp)`` returns ``(params, metas)``, two
trees of the reference's structure: ``{"groups": [{"p0": {"attn": {...},
"mix": {...}}}, ...], "embed", "head", "final_norm"}``, each group's
leaves stacked over its layers (leading dim ``layers_per_group``). Shapes
and metas equal the reference's; the values are drawn from an explicit
``torch.Generator`` seeded with ``seed`` on ``device`` (normal, std 0.02;
output projections 0.02/sqrt(2L); norm scales ones), so they are not the
reference's ``jax.random`` draws — carry those across with
:func:`repro_torch.convert.convert_lm_params`. Shapes are global logical
at ``tp``: head counts and the vocabulary are padded up to TP
divisibility as in the reference (:func:`eff_heads`, :func:`eff_kv_heads`,
:func:`eff_vocab`), padded head rows and columns zero (qwen3-1.7b at tp 2
needs no padding).

``device="meta"`` gives the shapes without allocating anything.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.meta import SEQ_NORM, ParamMeta
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

    def masked_heads(self, w, real_heads, padded_heads, hd, dim):
        """Zero the padded head rows/cols so that padding is inert."""
        if self.device.type == "meta" or real_heads == padded_heads:
            return w
        keep = torch.arange(w.shape[dim], device=w.device) < real_heads * hd
        return w * (keep[None, :] if dim == 1 else keep[:, None]).to(w.dtype)


def _attn_params(mk: Maker, cfg: ModelConfig, tp: int):
    d, hd = cfg.d_model, cfg.head_dim
    H, Kv = eff_heads(cfg, tp), eff_kv_heads(cfg, tp)
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias is not ported (qwen2.5 family, ROADMAP item 11)")
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
    if cfg.qk_norm:
        p["q_norm"] = mk.ones((hd,))
        p["k_norm"] = mk.ones((hd,))
        m["q_norm"] = ParamMeta(tp_dim=None, compress=False, grad_sync_model=True)
        m["k_norm"] = ParamMeta(tp_dim=None, compress=False, grad_sync_model=True)
    return p, m


def _mlp_params(mk: Maker, cfg: ModelConfig):
    d, ff = cfg.d_model, cfg.d_ff
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


def _block_params(mk: Maker, cfg: ModelConfig, tp: int):
    pa, ma = _attn_params(mk, cfg, tp)
    p, m = {"attn": pa}, {"attn": ma}
    if cfg.d_ff:
        p["mix"], m["mix"] = _mlp_params(mk, cfg)
    return p, m


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
    reps = cfg.layers_per_group // len(cfg.pattern)
    groups_p, groups_m = [], []
    for _ in range(cfg.num_groups):
        stack_p, meta = [], None
        for _ in range(reps):
            p, meta = _block_params(mk, cfg, tp)
            stack_p.append(p)
        groups_p.append({"p0": _stack(stack_p)})
        groups_m.append({"p0": meta})

    d, V = cfg.d_model, eff_vocab(cfg, tp)
    params = {"groups": groups_p, "embed": mk.normal((V, d))}
    metas = {"groups": groups_m, "embed": ParamMeta(tp_dim=0, tp_units=V)}
    if not cfg.tie_embeddings:
        params["head"] = mk.normal((d, V))
        metas["head"] = ParamMeta(tp_dim=1, tp_units=V)
    params["final_norm"] = mk.ones((d,))
    metas["final_norm"] = SEQ_NORM
    return params, metas
