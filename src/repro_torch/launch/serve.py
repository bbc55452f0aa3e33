"""Serving launcher (twin of ``repro.launch.serve``): continuous batching
over the slotted (default) or block-paged (``--paged``) KV cache, with the
static one-shot path as the reference (``--check-static``), on one GPU or
on an FSDP×TP mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --prompt-lens 512,512,384,256,200 --gen 16 --max-slots 2 \\
      [--mesh 1x2] [--weight-stationary] [--check-static | --static] [--reduced] \\
      [--device cpu] [--plan plan.json | --round-to 2 --act-round-to 2] \\
      [--seq-parallel] [--chunks C] [--requests N --prompt-len L] \\
      [--contiguous | --paged [--page-size 64] [--num-pages N] [--no-share-prefix]] \\
      [--shared-prefix N] [--int8-kv] [--window W] \\
      [--temperature T [--top-p P] [--top-k K] [--seed S]] \\
      [--spec-decode [--draft tiny] [--spec-k 4]]

Weights are random, from seed 0 (``repro_torch.models.init``). The plan
is ``--plan``'s JSON file, else ``PrecisionPlan.build`` from
``--round-to`` (default 2, the reference launcher's: bf16 planes) and
``--act-round-to`` (the TP-region all-reduces; default 4); the layout
flags ``--seq-parallel`` (the sequence-parallel prefill layout),
``--int8-kv`` (int8 KV caches) and ``--chunks`` (the weight gather's plane
blocks) override either, as in the reference. The requests are
``--prompt-lens``' lengths, else ``--requests`` prompts of
``--prompt-len`` tokens (the reference's defaults, 8 of 64);
``--static`` runs only the static one-shot path and prints its first
streams (a MoE model's static run goes request by request, as the
reference launcher's: its capacity dispatch ranks a batch's tokens);
``--contiguous`` names the default slotted layout (exclusive with
``--paged``). A
plan's ``"dtype": "bf16"`` serves in bf16: weights cast after the unpack,
bf16 KV caches, and the bf16 attention kernels on the card. ``--temperature`` (> 0) switches every
request to seeded sampling with ``--top-p`` / ``--top-k``, request i at
seed ``--seed + i``; ``--window W`` serves with a sliding window (cache
capacity ``min(max prompt + gen, W)``, a ring when the prompts reach it);
``--spec-decode`` adds speculative decoding with ``--draft`` (``tiny``,
random weights from seed 1, or an arch name) proposing ``--spec-k`` ids a
round, and checks the measured wire against ``serve_spec_decode_bytes``.
``--shared-prefix N`` prepends N common tokens to every prompt. ``--mesh``
is ``DPxTP`` or ``PODSxDPxTP``, parsed as in training: anything but
``1x1`` runs ``pods × dp × tp`` ranks, processes spawned by
``repro_torch.launch.mesh.spawn_ranks`` that meet in a gloo group; each
builds its blocks of the weights in turn with the others waiting (one
whole model at a time on a shared card) and runs the same engine loop on
its TP slice. Rank 0 prints the reference launcher's lines and, on a
mesh, the engine's collectives per traffic class against the plan's
``serve_wire_table`` (``[OK ...]`` or ``[MISMATCH ...]``). Runs on
``cuda`` unless ``--device cpu``. ``--ckpt`` serves the weights of a
training checkpoint (``load_storage``, either package's) and takes its
plan unless ``--plan`` overrides it, as the reference does; on a mesh rank
0 reads it and scatters each rank its blocks. An export written without
residual tiers is read at ``quality="wire"`` (the widths it was priced at;
the reference's launcher reads every checkpoint at ``exact`` and raises on
such an export). Speculative decoding and windows run on any mesh: the
draft on the target's mesh, every rank's acceptance decided on the
gathered logits. A vision arch (llama-3.2-vision-90b) serves with
``--static`` only, each request with ``(num_image_tokens, vision_dim)``
image features drawn from ``default_rng(0)`` in request order (the
reference's draw); an encoder-only arch (hubert-xlarge) has no decode
path and exits.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
import warnings

import numpy as np

from repro_torch import fp32_math, resolve_device
from repro_torch.checkpoint.ckpt import ckpt_dir, load_plan, load_storage
from repro_torch.checkpoint.sharded import read_meta
from repro_torch.configs.registry import ARCHS, get_config, reduced
from repro_torch.dist.spec import MeshCfg
from repro_torch.launch.mesh import make_mesh_from_cfg, spawn_ranks
from repro_torch.launch.train import parse_mesh, rank_device, setup_storage
from repro_torch.plan import PrecisionPlan, SamplingParams
from repro_torch.roofline.analysis import serve_host_device_bytes, serve_spec_decode_bytes
from repro_torch.serve.engine import Request, ServeEngine, generate_static
from repro_torch.serve.spec import build_draft
from repro_torch.train.step import COLLECTIVE_CLASSES


def sampling_for(rid: int, temperature: float = 0.0, top_p: float = 1.0, top_k: int = 0,
                 seed: int = 0) -> SamplingParams:
    """Request ``rid``'s :class:`SamplingParams`, as the reference launcher
    builds them: greedy at ``temperature <= 0``, else one shared
    temperature / top-p / top-k and a seed of its own, ``seed + rid``."""
    if temperature <= 0:
        return SamplingParams()
    return SamplingParams(temperature=temperature, top_p=top_p, top_k=top_k, seed=seed + rid)


def build_requests(prompt_lens, gen: int, vocab_size: int, *,
                   shared_prefix: int = 0, **sampling) -> list[Request]:
    """Requests with prompts drawn from ``default_rng(0)``, as the
    reference launcher draws them: first ``shared_prefix`` tokens common to
    every prompt, then each prompt's own ``prompt_lens[i]`` tokens (with no
    prefix the prompts are the same as without the option). ``sampling``
    is :func:`sampling_for`'s keywords (greedy without them)."""
    rng = np.random.default_rng(0)
    shared = tuple(int(t) for t in rng.integers(0, vocab_size, shared_prefix))
    return [
        Request(rid=i, max_new=gen, sampling=sampling_for(i, **sampling),
                prompt_ids=shared + tuple(int(t) for t in rng.integers(0, vocab_size, S)))
        for i, S in enumerate(prompt_lens)
    ]


def setup(cfg, *, seed: int, device, mesh_cfg: MeshCfg | None = None, rank: int = 0,
          params=None):
    """``(mesh_cfg, spec_tree, storage)`` for random weights from ``seed``
    (or ``params``): on a mesh rank ``rank``'s blocks, built in turn
    (``launch.train.setup_storage``)."""
    mesh_cfg = mesh_cfg or MeshCfg()
    spec_tree, storage = setup_storage(cfg, mesh_cfg, device=device, params=params,
                                       rank=rank, seed=seed)
    return mesh_cfg, spec_tree, storage


def check_wire(engine: ServeEngine, plan, requests) -> dict:
    """The engine's measured host<->device bytes must equal the analytic
    serve model for the run's geometry (the speculative one with a draft);
    returns the analytic table."""
    summary = engine.wire_summary()
    geometry = dict(n_slots=engine.max_slots, prompt_lens=[len(r.prompt_ids) for r in requests],
                    page_table_entries=summary.get("page_table_entries", 0))
    if engine.draft is not None:
        analytic = serve_spec_decode_bytes(plan, engine.cfg.vocab_size,
                                           spec_rounds=summary["spec_rounds"],
                                           spec_k=engine.spec_k, **geometry)
    else:
        analytic = serve_host_device_bytes(plan, engine.cfg.vocab_size,
                                           decode_steps=summary["decode_steps"], **geometry)
    if summary["host_device"] != analytic["total"]:
        raise SystemExit(f"measured host_device {summary['host_device']} B != "
                         f"analytic {analytic['total']} B ({analytic})")
    return analytic


def wire_against_table(engine: ServeEngine) -> tuple[dict, dict]:
    """``(measured, table)`` per collective class, summed over the engine's
    forwards: the collectives' log (``wire_log``) and
    :meth:`ServeEngine.wire_tables`."""
    got = {k: sum(r["wire"].get(k, 0) for r in engine.wire_log) for k in COLLECTIVE_CLASSES}
    want = {k: sum(t[k] for t in engine.wire_tables()) for k in COLLECTIVE_CLASSES}
    return got, want


def check_streams(results, static_streams) -> None:
    bad = [rid for rid in sorted(results) if results[rid].tokens != static_streams[rid]]
    if bad:
        raise SystemExit(f"continuous vs static token streams DIVERGED for requests {bad}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="1x1", help="DPxTP or PODSxDPxTP")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--prompt-lens", default="",
                    help="comma-separated per-request prompt lengths; overrides "
                         "--requests/--prompt-len")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-slots", type=int, default=0,
                    help="KV slots resident in the engine (default min(4, requests))")
    ap.add_argument("--plan", default="",
                    help="PrecisionPlan JSON (the layout flags override it)")
    ap.add_argument("--ckpt", default="",
                    help="serve the weights (and, unless --plan overrides it, the plan) "
                         "of a training checkpoint")
    ap.add_argument("--round-to", type=int, default=None,
                    help="ADT weight wire format (plan-builder sugar, default 2; "
                         "ignored with --plan)")
    ap.add_argument("--act-round-to", type=int, default=None,
                    help="activation wire format of the TP-region all-reduces "
                         "(plan-builder sugar, default 4; ignored with --plan)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="sequence-parallel prefill activations (decode keeps the psum "
                         "layout)")
    ap.add_argument("--chunks", type=int, default=None,
                    help="weight-gather chunk count (overrides the plan's)")
    ap.add_argument("--weight-stationary", action="store_true")
    ap.add_argument("--static", action="store_true",
                    help="run only the static one-shot reference path")
    ap.add_argument("--check-static", action="store_true",
                    help="also run the static reference and require equal streams")
    ap.add_argument("--device", default="cuda")
    layout = ap.add_mutually_exclusive_group()
    layout.add_argument("--paged", action="store_true",
                        help="block-paged KV layout: page pool + per-slot page table, "
                             "shared-prefix pages refcounted")
    layout.add_argument("--contiguous", action="store_true",
                        help="slotted contiguous KV layout (the default)")
    ap.add_argument("--page-size", type=int, default=64, help="tokens per KV page (--paged)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page-pool size (default: slots x table width)")
    ap.add_argument("--no-share-prefix", action="store_true",
                    help="disable shared-prefix page interning (--paged)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many common tokens to every prompt")
    ap.add_argument("--int8-kv", action="store_true", help="int8 KV caches (fp32 scales)")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window decode override (long-context)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy; > 0 samples every request)")
    ap.add_argument("--top-p", type=float, default=1.0, help="nucleus cutoff (--temperature)")
    ap.add_argument("--top-k", type=int, default=0, help="top-k cutoff, 0 = all (--temperature)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed; request i uses seed + i")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decoding: the draft proposes --spec-k ids a slot, "
                         "the target verifies them in one step")
    ap.add_argument("--draft", default="tiny",
                    help="draft model: 'tiny' (the target shrunk, same vocabulary, random "
                         "weights from seed 1) or an arch name (--spec-decode)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft proposals a round (--spec-decode)")
    return ap


def plan_from_args(args, nrt: int) -> PrecisionPlan:
    """The reference launcher's plan resolution: ``--plan`` wins, then the
    plan saved with ``--ckpt``, else the precision flags build one
    (``--round-to`` default 2, ``--act-round-to`` default 4); the layout
    flags override any source."""
    plan = None
    if args.plan:
        plan = PrecisionPlan.from_file(args.plan).broadcast(nrt)
    elif args.ckpt:
        plan = load_plan(args.ckpt)
        if plan is not None:
            plan = plan.broadcast(nrt)
        else:
            warnings.warn(
                f"checkpoint {args.ckpt} carries no PrecisionPlan: serving falls back to the "
                "flag-built plan (pass --plan to pin the formats the run used)", stacklevel=2)
    if plan is None:
        plan = PrecisionPlan.build(
            nrt, round_to=args.round_to if args.round_to is not None else 2,
            act_round_to=args.act_round_to if args.act_round_to is not None else 4)
    overrides = {}
    if args.seq_parallel:
        overrides["seq_parallel"] = True
    if args.int8_kv:
        overrides["int8_kv"] = True
    if args.chunks is not None:
        overrides["chunks"] = args.chunks
    return dataclasses.replace(plan, **overrides) if overrides else plan


def prompt_lens(args) -> list[int]:
    """``--prompt-lens``, else ``--requests`` prompts of ``--prompt-len``."""
    if args.prompt_lens:
        return [int(s) for s in args.prompt_lens.split(",")]
    return [args.prompt_len] * args.requests


def restore(path: str, storage, spec_tree, mesh_cfg: MeshCfg):
    """``(storage, step)`` of a training checkpoint's weights for serving:
    at ``quality="wire"`` when it was written without residual tiers (an
    export), else exact; on a mesh rank 0 reads and each rank gets its
    blocks."""
    d = ckpt_dir(path)  # a legacy .npz is full precision
    quality = "wire" if os.path.isdir(d) and not read_meta(d)["residuals"] else "exact"
    return load_storage(path, storage, quality=quality, spec_tree=spec_tree, mesh_cfg=mesh_cfg)


def image_features_for(cfg, requests) -> dict | None:
    """A vision arch's ``{rid: (num_image_tokens, vision_dim) fp32}``
    image features, normals from one ``default_rng(0)`` in request order
    (the reference launcher's draw); ``None`` for the other archs."""
    if not cfg.num_image_tokens:
        return None
    frng = np.random.default_rng(0)
    return {r.rid: frng.normal(0, 1, (cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)
            for r in requests}


def run_static(cfg, mesh_cfg, mesh, spec_tree, storage, requests, plan, window) -> dict:
    """The static reference's streams. A MoE model's capacity dispatch ranks
    a whole batch's tokens per expert, so a grouped static prefill is no
    target for the engine's batch-of-1 prefills: its static run goes
    request by request, as the reference launcher's does."""
    if not cfg.num_experts:
        return generate_static(cfg, mesh_cfg, mesh, spec_tree, storage, requests, plan=plan,
                               window=window)
    streams = {}
    for r in requests:
        streams.update(generate_static(cfg, mesh_cfg, mesh, spec_tree, storage, [r],
                                       plan=plan, window=window))
    return streams


def _serve(rank: int, args, params=None) -> dict:
    """The static reference (``--check-static``) and the engine run of
    :func:`main` on rank ``rank`` (the only one on ``1x1``); checks the
    host<->device bytes and returns plain data."""
    fp32_math()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mesh_cfg = parse_mesh(args.mesh)
    device = rank_device(args, rank, mesh_cfg.dshards * mesh_cfg.tp)
    mesh = make_mesh_from_cfg(mesh_cfg)
    _, spec_tree, storage = setup(cfg, seed=0, device=device, mesh_cfg=mesh_cfg, rank=rank,
                                  params=params)
    plan = plan_from_args(args, cfg.num_groups + 1)
    restored = None
    if args.ckpt:
        storage, ckpt_step = restore(args.ckpt, storage, spec_tree, mesh_cfg)
        restored = (f"restored weights from {args.ckpt} (train step {ckpt_step}, "
                    f"plan rts {plan.round_tos})")
    requests = build_requests(prompt_lens(args), args.gen,
                              cfg.vocab_size, shared_prefix=args.shared_prefix,
                              temperature=args.temperature, top_p=args.top_p,
                              top_k=args.top_k, seed=args.seed)
    feats = image_features_for(cfg, requests)
    if feats is not None:
        requests = [dataclasses.replace(r, image_features=feats[r.rid]) for r in requests]
    lens = [len(r.prompt_ids) for r in requests]
    slots = args.max_slots or min(4, len(requests))
    window = args.window or None
    # a windowed cache rings only at capacity <= window (the engine checks
    # it): capped at the window, long prompts wrap instead of overflowing
    cap = max(lens) + args.gen if window is None else min(max(lens) + args.gen, window)
    out = {"cfg": cfg.name, "device": str(device), "lens": lens, "slots": slots,
           "restored": restored,
           "mesh": mesh_cfg.shape, "trivial": mesh_cfg.trivial, "static": None}
    if args.check_static or args.static:
        t0 = time.perf_counter()
        out["static"] = run_static(cfg, mesh_cfg, mesh, spec_tree, storage, requests, plan,
                                   window)
        out["static_s"] = time.perf_counter() - t0
        out["static_kind"] = "per-request static" if cfg.num_experts else "static one-shot"
        if args.static:
            return out
    draft = None
    if args.spec_decode:
        draft = build_draft(cfg, mesh_cfg, args.draft, device=device)
        out["draft"] = draft.cfg.name
    engine = ServeEngine(cfg, mesh_cfg, mesh, spec_tree, storage, plan=plan,
                         max_slots=slots, cache_capacity=cap, window=window,
                         weight_stationary=args.weight_stationary, paged=args.paged,
                         page_size=args.page_size, num_pages=args.num_pages or None,
                         share_prefix=not args.no_share_prefix, draft=draft,
                         spec_k=args.spec_k if draft is not None else None)
    t0 = time.perf_counter()
    results = engine.run(requests)
    out["wall"] = time.perf_counter() - t0
    out["results"] = results
    out["summary"] = engine.wire_summary()
    out["analytic"] = check_wire(engine, plan, requests)
    out["wire"] = wire_against_table(engine)
    out["place_wire"] = engine.place_wire
    if args.paged:
        out["residency"], out["audit"] = engine.kv_residency(), engine.pages.audit()
    return out


def main(argv=None, *, params=None):
    """Run the launcher; returns rank 0's ``{rid: GenResult}`` (with
    ``--static``, its ``{rid: ids}``). ``params`` replaces the seeded
    weights (a port LM tree at the mesh's ``tp``)."""
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    if cfg.num_image_tokens and not args.static:
        # image payloads are not token-stageable through the engine's boundary
        raise SystemExit(f"{args.arch} has image inputs: serve it with --static (the "
                         "continuous-batching engine stages token payloads only)")
    mesh_cfg = parse_mesh(args.mesh)
    if mesh_cfg.trivial:
        out = _serve(0, args, params)
    else:
        world = mesh_cfg.dshards * mesh_cfg.tp
        resolve_device(args.device)  # a missing card fails here, not in the ranks
        threads = 1 if args.device == "cpu" else max(1, (os.cpu_count() or 1) // world)
        out = spawn_ranks(_serve, world, args, params, threads=threads)[0]
    if out["restored"]:
        print(out["restored"])
    if out["static"] is not None:
        print(f"{out['static_kind']} reference: {len(out['static'])} requests in "
              f"{out['static_s']:.2f}s")
    if args.static:
        for rid in sorted(out["static"])[:4]:
            print(f"  req{rid}: {out['static'][rid][:16]}")
        return out["static"]
    results, summary, analytic, lens = out["results"], out["summary"], out["analytic"], out["lens"]
    total_new = sum(len(r.tokens) for r in results.values())
    print(f"{out['cfg']} on {out['device']}, mesh {out['mesh']}: {len(results)} requests, "
          f"prompts {min(lens)}..{max(lens)}, +{args.gen} tokens, {out['slots']} slots")
    print(f"engine: {summary['steps']} steps ({summary['decode_steps']} decode) in "
          f"{out['wall']:.2f}s ({total_new / max(out['wall'], 1e-9):.1f} tok/s)")
    model = "serve_spec_decode_bytes" if args.spec_decode else "serve_host_device_bytes"
    print(f"host_device wire: {summary['host_device']} B staged at "
          f"{summary['token_width']} B/token == {model} {analytic['total']} B")
    if args.spec_decode:
        print(f"spec decode: draft {out['draft']}, {summary['spec_rounds']} rounds, acceptance "
              f"{summary['acceptance_rate']:.2f}, {summary['tokens_per_target_step']:.2f} "
              f"emitted tokens/target step (k={summary['spec_k']}), "
              f"{summary['host_device'] / max(total_new, 1):.2f} B/token")
    if not out["trivial"]:
        got, want = out["wire"]
        status = "OK" if got == want else "MISMATCH"
        shown = ", ".join(f"{k} {v} B" for k, v in got.items() if v) or "none"
        other = ", ".join(f"{k} {v} B" for k, v in summary["wire"].items()
                          if k not in COLLECTIVE_CLASSES)
        print(f"measured wire by class (rank 0, the engine's steps): {shown} [{status} "
              f"against serve_wire_table]; not priced: {other}")
        if args.weight_stationary:
            print(f"placement wire (once): {out['place_wire']}")
    if args.paged:
        res, audit = out["residency"], out["audit"]
        print(f"paged KV: page_size={res['page_size']}, {audit['allocs']} page allocs / "
              f"{audit['releases']} releases, peak {res['pages_peak']} pages resident "
              f"({res['kv_bytes_peak']} B at {res['bytes_per_page']} B/page)")
        print(f"paged prefill: {summary['prefill_misses']} bucket lengths first seen, "
              f"{summary['prefill_hits']} seen before; page-table staging "
              f"{summary['page_table']} B")
    for rid in sorted(results)[:4]:
        print(f"  req{rid}: {results[rid].tokens[:16]}")
    if out["static"] is not None:
        check_streams(results, out["static"])
        print(f"check-static: {len(results)} streams equal to the static reference")
    return results


if __name__ == "__main__":
    main()
