"""Carry weights across from the reference package's layouts.

``convert_lm_params`` takes ``repro.models.init.init_params``'s params as
numpy arrays (``{"groups": [{"p0": {...}, "p1": ...}], "embed", "head",
"final_norm"}``, one ``p<i>`` per position of the block pattern; the
input stub's ``embed_in`` in place of ``embed``, a VLM's ``img_proj``) and
returns the port's tree on ``device``. The port keeps the reference's
``(in, out)`` weight layouts, its ``(dvh, H)`` mLSTM value columns and its
per-group stacking, so this is an exact copy: same keys, shapes and
values — the QKV biases, the router, the ``(E, ...)`` expert leaves and
arctic's ``dense_*``, the ``mlstm`` / ``slstm`` / ``rglru`` leaves (the
RG-LRU's ``lam`` constant among them), the ``local`` attention blocks,
the cross blocks' 0-d ``gate`` and the GeLU MLP's ``w_up`` / ``w_down``.

``convert_cnn_params`` takes ``repro.models.cnn.init_cnn``'s params as
numpy arrays (``{"layers": {name: {key: array}}}``, as ``np.asarray`` gives
them) and returns the port's params on ``device``:

  * convolution weights HWIO -> OIHW (the port runs NCHW);
  * the first fully-connected weight after the convolutions (when the
    spatial size is still > 1) has its input rows re-ordered from the
    reference's NHWC flatten ``(h, w, c)`` to the port's NCHW flatten
    ``(c, h, w)``;
  * everything else (biases, norm scales, later fc weights) is copied.

``convert_draft`` takes the reference draft's params
(``repro.serve.spec.build_draft(cfg, mesh_cfg, "tiny")``'s
``init_params(make_draft_config(cfg), PRNGKey(seed))``, as numpy arrays)
and returns the port's :class:`~repro_torch.serve.spec.DraftBundle` of
the same weights.

``convert_cache`` takes a reference cache node whose leaves are numpy
arrays (``KVCache``, ``QuantKVCache``, ``PagedKVCache`` or
``PagedQuantKVCache``, stacked or not) and returns the port's node of the
same class with the same values, so that the attention functions can
start from identical state in both packages; ``convert_paged_cache`` is
its paged fp32 case.

The values are moved exactly, so both packages can start a run from the
same weights (and caches).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models import attention as A
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.cnn import CNNConfig
from repro_torch.models.init import eff_vocab


def _fc_rows(w: np.ndarray, hw: int, ch: int) -> np.ndarray:
    if hw <= 1:
        return w
    out = w.shape[1]
    return w.reshape(hw, hw, ch, out).transpose(2, 0, 1, 3).reshape(-1, out)


def convert_lm_params(cfg, params, *, device="cuda", tp: int = 1):
    """Reference-layout numpy LM params (``init_params(cfg, key, tp)``'s)
    -> port params (an exact copy, tensors on ``device``). ``cfg`` and
    ``tp`` are checked against the tree's shapes."""
    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return put(tree)

    if len(params["groups"]) != cfg.num_groups:
        raise ValueError(f"{len(params['groups'])} groups, config has {cfg.num_groups}")
    keys = {f"p{i}" for i in range(len(cfg.pattern))}
    if any(set(g) != keys for g in params["groups"]):
        raise ValueError(f"group keys {sorted(params['groups'][0])} do not match {cfg.name}'s "
                         f"{len(cfg.pattern)}-block pattern")
    if cfg.embed_is_input_stub:
        if tuple(np.shape(params["embed_in"])) != (cfg.vision_dim, cfg.d_model):
            raise ValueError(f"embed_in {np.shape(params['embed_in'])} does not match "
                             f"{cfg.name}")
    elif tuple(np.shape(params["embed"])) != (eff_vocab(cfg, tp), cfg.d_model):
        raise ValueError(f"embed {np.shape(params['embed'])} does not match {cfg.name}")
    out = {k: walk(v) for k, v in params.items() if k != "groups"}
    return {"groups": [walk(g) for g in params["groups"]], **out}


def convert_cnn_params(cfg: CNNConfig, params, *, device="cuda"):
    """Reference-layout numpy params -> port params (tensors on ``device``)."""
    src = params["layers"]
    out: dict = {}
    hw, ch = cfg.in_hw, cfg.in_ch

    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def conv(name):
        layer = dict(src[name])
        layer["w"] = np.transpose(layer["w"], (3, 2, 0, 1))  # HWIO -> OIHW
        out[name] = {k: put(v) for k, v in layer.items()}
        return layer["w"].shape[0]

    def dense(name):
        layer = dict(src[name])
        layer["w"] = _fc_rows(layer["w"], hw, ch)
        out[name] = {k: put(v) for k, v in layer.items()}
        return layer["w"].shape[1]

    n = 0
    for spec in cfg.layers:
        kind = spec[0]
        if kind == "conv":
            ch = conv(f"conv{n}")
            hw = max(1, math.ceil(hw / spec[3]))
            n += 1
        elif kind == "pool":
            hw = max(1, hw // 2)
        elif kind == "block":
            _, cout, s, reps = spec
            for r in range(reps):
                stride = s if r == 0 else 1
                for part in "abp":
                    if f"block{n}{part}" in src:
                        conv(f"block{n}{part}")
                ch = cout
                hw = max(1, math.ceil(hw / stride))
                n += 1
        elif kind == "gap":
            hw = 1
        elif kind == "fc":
            ch, hw = dense(f"fc{n}"), 1
            n += 1
        else:
            raise ValueError(kind)
    dense("head")
    return {"layers": out}


def convert_draft(cfg, mesh_cfg, params, name: str = "tiny", *, device="cuda"):
    """Reference-layout numpy params of ``cfg``'s draft (the reference's
    ``make_draft_config(cfg, name)``) -> the port's ``DraftBundle`` on
    ``device`` with the same weights."""
    from repro_torch.serve.spec import build_draft, make_draft_config

    dparams = convert_lm_params(make_draft_config(cfg, name), params, device=device,
                                tp=mesh_cfg.tp)
    return build_draft(cfg, mesh_cfg, name, device=device, params=dparams)


_CACHE_FIELDS = {
    "KVCache": ("k", "v", "pos"),
    "QuantKVCache": ("k", "v", "k_scale", "v_scale", "pos"),
    "PagedKVCache": ("k", "v", "pos"),
    "PagedQuantKVCache": ("k", "v", "k_scale", "v_scale", "pos"),
}


def convert_cache(cache, *, device="cuda"):
    """Reference cache node with numpy leaves -> the port's node of the
    same class name (an exact copy on ``device``; ``pos`` is int32)."""
    name = type(cache).__name__
    if name not in _CACHE_FIELDS:
        raise TypeError(f"no port counterpart of cache node {name}")
    leaves = []
    for f in _CACHE_FIELDS[name]:
        x = np.asarray(getattr(cache, f))
        leaves.append(torch.from_numpy((x.astype(np.int32) if f == "pos" else x).copy())
                      .to(device))
    return getattr(A, name)(*leaves)


def convert_paged_cache(cache, *, device="cuda") -> PagedKVCache:
    """Reference ``PagedKVCache`` with numpy leaves -> the port's (an exact
    copy on ``device``: pools keep their float dtype, ``pos`` is int32)."""
    k, v = np.shape(cache.k), np.shape(cache.v)
    if k != v or len(k) < 4:
        raise ValueError(f"need pools (..., P, page, Kv, hd); got {k}, {v}")
    return convert_cache(cache, device=device)
