"""Plain reference of a dense decoder LM training step (the Qwen3 block):
token embedding; per layer RMSNorm, Q/K/V projections, RMSNorm of each
query and key head (qk-norm), rotary embedding on interleaved pairs,
causal softmax attention with key/value heads shared by groups of query
heads, the output projection and the residual; RMSNorm and a SwiGLU
(``silu(x Wg) * (x Wu) Wd``) and the residual; a final RMSNorm, logits
against the (tied) embedding and the summed token NLL over ``B * S``.
Every matrix used after a transfer at the mix's ``round_to``
(straight-through gradient); each layer recomputed in the backward
(``torch.utils.checkpoint``) so that the step fits; momentum SGD with
weight decay on the matrices; the sums of squares of the matrices of each
group of consecutive layers, and of the embedding, after the update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import inputs
from bench.reference import common


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x (B, S, H, hd): pairs (2i, 2i+1) rotated by position * theta^(-2i/hd)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device).float() / hd)
    ang = torch.arange(S, device=x.device).float()[:, None] * inv
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1).flatten(-2)


def _layer(x, w, doc, rt):
    eps, hd = doc["rms_norm_eps"], doc["head_dim"]
    H, Kv = doc["num_attention_heads"], doc["num_key_value_heads"]
    B, S, _ = x.shape
    h = _rms(x, w["attn_ln"], eps)
    q = (h @ common.transfer(w["wq"], rt)).view(B, S, H, hd)
    k = (h @ common.transfer(w["wk"], rt)).view(B, S, Kv, hd)
    v = (h @ common.transfer(w["wv"], rt)).view(B, S, Kv, hd)
    q = _rope(_rms(q, w["q_norm"], eps), doc["rope_theta"]).transpose(1, 2)
    k = _rope(_rms(k, w["k_norm"], eps), doc["rope_theta"]).transpose(1, 2)
    k = k.repeat_interleave(H // Kv, dim=1)
    v = v.transpose(1, 2).repeat_interleave(H // Kv, dim=1)
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    a = (p @ v).transpose(1, 2).reshape(B, S, H * hd)
    x = x + a @ common.transfer(w["wo"], rt)
    h = _rms(x, w["mix_ln"], eps)
    g = F.silu(h @ common.transfer(w["w_gate"], rt)) * (h @ common.transfer(w["w_up"], rt))
    return x + g @ common.transfer(w["w_down"], rt)


def loss(doc, weights, tokens, labels, rt):
    """Summed token NLL over ``B * S``."""
    emb = common.transfer(weights["embed"], rt)
    x = emb[tokens]
    per = [k for k in weights if k not in ("embed", "final_norm")]
    for layer in range(doc["num_hidden_layers"]):
        w = {k: weights[k][layer] for k in per}
        x = checkpoint(_layer, x, w, doc, rt, use_reentrant=False)
    x = _rms(x, weights["final_norm"], doc["rms_norm_eps"])
    logits = x @ emb.T
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels[..., None])[..., 0]
    return (lse - tgt).sum() / labels.numel()


def decayed(name: str) -> bool:
    return name.split(".")[0] in inputs.LM_KINDS + ("embed",)


def group_sums(doc, w) -> list[float]:
    """Sums of squares of the matrices of each group of consecutive layers,
    then of the embedding."""
    L, G = doc["num_hidden_layers"], doc["num_precision_groups"]
    R = L // min(G, L)
    out = []
    for g in range(L // R):
        out.append(sum(float((w[k][g * R:(g + 1) * R].double() ** 2).sum())
                       for k in inputs.LM_KINDS))
    out.append(float((w["embed"].double() ** 2).sum()))
    return out


def per_layer(tensors: dict) -> dict:
    """Stacked ``(L, ...)`` leaves split into ``<kind>.<layer>``."""
    out = {}
    for k, v in tensors.items():
        if k in ("embed", "final_norm"):
            out[k] = v
        else:
            out.update({f"{k}.{i}": v[i] for i in range(v.shape[0])})
    return out


def train(doc, mix, seed, device, *, steps=3, tf32=False, weights=None) -> dict:
    """The readings of the first ``steps`` steps from ``seed``."""
    lm = mix["batch"]["lm"]
    pool, rt, opt = mix["pool"], mix["round_to"], doc["optimizer"]
    w = weights if weights is not None else inputs.lm_weights(doc, seed, device)
    tokens, labels = inputs.lm_batches(doc, lm["sequences"], lm["seq_len"], pool, seed, device)
    p0 = {k: v.clone() for k, v in w.items()}
    moms = {k: torch.zeros_like(v) for k, v in w.items()}
    out = common.new_readings()
    with common.precision(tf32):
        for i in range(steps):
            live = {k: v.requires_grad_(True) for k, v in w.items()}
            lo = loss(doc, live, tokens[i % pool], labels[i % pool], rt)
            grads = dict(zip(live, torch.autograd.grad(lo, list(live.values()))))
            out["losses"].append(float(lo.detach()))
            if i == 0:
                out["grad1"] = common.norms(per_layer(grads))
            w = {k: v.detach() for k, v in live.items()}
            common.sgd(w, grads, moms, decayed, opt, opt["lr"])
            del grads
            out["monitor"].append(group_sums(doc, w))
    out["update3"] = common.norms(per_layer({k: w[k] - p0[k] for k in w}))
    return out
