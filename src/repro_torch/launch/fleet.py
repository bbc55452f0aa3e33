"""Disaggregated fleet serving launcher (twin of ``repro.launch.fleet``):
a request router over ``--replicas`` paged decode replicas with
``--workers`` dedicated prefill workers, KV pages migrating as byte-plane
fabric parcels, and an optional mid-run weight refresh.

  PYTHONPATH=src python -m repro_torch.launch.fleet --arch qwen3-1.7b --reduced \\
      --replicas 2 --workers 1 --prompt-lens 16,12,16,8 --gen 8 --page-size 8 \\
      [--int8-kv] [--refresh-at 2] [--check-static] [--device cpu] \\
      [--plan plan.json | --round-to 2 --act-round-to 4] \\
      [--temperature T [--top-p P] [--top-k K] [--seed S]] [--shared-prefix N]

Weights are random: version 0 from seed 0, the ``--refresh-at`` version
from seed 1 (``repro_torch.models.init``). ``--refresh-at N`` publishes
version 1 once N requests have completed and submits a second wave
(prompts drawn from ``default_rng(1)``) pinned to it. After the drain the
launcher prints the reference launcher's lines (the fabric's totals, their
equality with :func:`~repro_torch.roofline.analysis.fleet_migration_bytes`,
which it enforces on every run, and the first streams); ``--check-static``
holds the streams to ``generate_static`` per version (the first wave to
version 0's weights, the second to version 1's). Runs on ``cuda`` unless
``--device cpu``. ``--mesh`` is ``DPxTP`` or ``PODSxDPxTP``, as in the
serve launcher: anything but ``1x1`` runs ``pods × dp × tp`` ranks,
processes spawned by ``repro_torch.launch.mesh.spawn_ranks`` (one CPU
thread each under ``--device cpu``), each running the same router,
replicas and workers on its TP slice; rank 0 prints the lines, and the
launcher exits non-zero when the fabric leaves ``fleet_migration_bytes``
or a stream leaves the static run on any rank.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from repro_torch import fp32_math, resolve_device
from repro_torch.configs.registry import ARCHS, get_config, reduced
from repro_torch.fleet import DecodeReplica, FleetRouter, PrefillWorker, WeightPublisher
from repro_torch.launch.mesh import make_mesh_from_cfg, spawn_ranks
from repro_torch.launch.serve import sampling_for, setup
from repro_torch.launch.train import parse_mesh, rank_device
from repro_torch.plan import PrecisionPlan
from repro_torch.roofline.analysis import fleet_migration_bytes
from repro_torch.serve.engine import Request, ServeEngine, generate_static


def plan_from_args(args, nrt: int) -> PrecisionPlan:
    """``--plan``, else the precision flags (``--round-to`` default 2,
    ``--act-round-to`` default 4); ``--int8-kv`` overrides either."""
    if args.plan:
        plan = PrecisionPlan.from_file(args.plan).broadcast(nrt)
    else:
        plan = PrecisionPlan.build(
            nrt, round_to=args.round_to if args.round_to is not None else 2,
            act_round_to=args.act_round_to if args.act_round_to is not None else 4)
    return dataclasses.replace(plan, int8_kv=True) if args.int8_kv else plan


def build_requests(args, vocab_size: int, *, rid_base: int, seed: int) -> list[Request]:
    """The reference launcher's waves: prompts from ``default_rng(seed)``,
    ``--shared-prefix`` common tokens then each prompt's own, request i at
    sampling seed ``--seed + rid``."""
    lens = ([int(s) for s in args.prompt_lens.split(",")] if args.prompt_lens
            else [args.prompt_len] * args.requests)
    rng = np.random.default_rng(seed)
    shared = tuple(int(t) for t in rng.integers(0, vocab_size, args.shared_prefix))
    return [
        Request(rid=rid_base + i, max_new=args.gen,
                prompt_ids=shared + tuple(int(t) for t in rng.integers(0, vocab_size, S)),
                sampling=sampling_for(rid_base + i, args.temperature, args.top_p, args.top_k,
                                      args.seed))
        for i, S in enumerate(lens)
    ]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="DPxTP or PODSxDPxTP: anything but 1x1 runs that many ranks")
    ap.add_argument("--replicas", type=int, default=2,
                    help="decode replicas (each one paged ServeEngine)")
    ap.add_argument("--workers", type=int, default=1,
                    help="dedicated prefill workers (round-robin)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--prompt-lens", default="",
                    help="comma-separated per-request prompt lengths; overrides "
                         "--requests/--prompt-len")
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=2, help="KV slots per replica")
    ap.add_argument("--page-size", type=int, default=8, help="tokens per KV page")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many common tokens to every prompt (prefix pages "
                         "then migrate once per replica)")
    ap.add_argument("--plan", default="",
                    help="PrecisionPlan JSON incl. the kv_migration / weight_publish entries")
    ap.add_argument("--round-to", type=int, default=None,
                    help="ADT weight wire format (plan-builder sugar)")
    ap.add_argument("--act-round-to", type=int, default=None,
                    help="activation wire format (plan-builder sugar)")
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus cutoff (with --temperature > 0)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k cutoff, 0 = all (with --temperature > 0)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed; request i uses seed + i")
    ap.add_argument("--refresh-at", type=int, default=0,
                    help="after this many completed requests, publish refreshed weights "
                         "(seed 1) and submit a second wave under the new version")
    ap.add_argument("--check-static", action="store_true",
                    help="require router streams equal to the static reference, per version")
    ap.add_argument("--device", default="cuda")
    return ap


def _fleet(rank: int, args, params=None, params1=None) -> dict:
    """The fleet run of :func:`main` on rank ``rank`` (the only one on
    ``1x1``): its printed lines, the first failed check's message (or
    ``None``) and the results, as plain data."""
    fp32_math()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mesh_cfg = parse_mesh(args.mesh)
    device = rank_device(args, rank, mesh_cfg.dshards * mesh_cfg.tp)
    mesh = make_mesh_from_cfg(mesh_cfg)
    _, spec_tree, storage0 = setup(cfg, seed=0, device=device, mesh_cfg=mesh_cfg, rank=rank,
                                   params=params)
    plan = plan_from_args(args, cfg.num_groups + 1)
    wave_a = build_requests(args, cfg.vocab_size, rid_base=0, seed=0)
    wave_b, storage1 = [], None
    if args.refresh_at:
        storage1 = setup(cfg, seed=1, device=device, mesh_cfg=mesh_cfg, rank=rank,
                         params=params1)[2]
        wave_b = build_requests(args, cfg.vocab_size, rid_base=len(wave_a), seed=1)
    lens = [len(r.prompt_ids) for r in wave_a]
    cap = max(lens) + args.gen
    lines: list[str] = []
    out = {"lines": lines, "error": None}

    replicas = [
        DecodeReplica(f"r{i}", ServeEngine(cfg, mesh_cfg, mesh, spec_tree, storage0, plan=plan,
                                           max_slots=args.max_slots, cache_capacity=cap,
                                           paged=True, page_size=args.page_size))
        for i in range(args.replicas)
    ]
    workers = [PrefillWorker(f"w{i}", cfg, mesh_cfg, mesh, spec_tree, plan=plan,
                             cache_capacity=cap, page_size=args.page_size)
               for i in range(args.workers)]
    router = FleetRouter(replicas, workers)
    publisher = WeightPublisher(cfg, spec_tree, plan=plan, mesh_cfg=mesh_cfg)
    parcel0 = publisher.publish(storage0)
    router.publish(parcel0)
    refreshed = {"done": not args.refresh_at}

    def do_refresh(r):
        refreshed["done"] = True
        r.publish(publisher.publish(storage1, step=1))
        for req in wave_b:
            r.submit(req)
        lines.append(f"tick {r.ticks}: published v1 and submitted {len(wave_b)} refresh-wave "
                     "requests")

    def on_tick(r):
        if not refreshed["done"] and len(r.results) >= args.refresh_at:
            do_refresh(r)

    t0 = time.perf_counter()
    results = router.run(wave_a, on_tick=on_tick)
    if not refreshed["done"]:  # wave A drained within the tick that crossed the threshold
        do_refresh(router)
        results = router.run([])
    wall = time.perf_counter() - t0
    out["results"] = results
    static0 = static1 = None
    if args.check_static:
        static0 = generate_static(cfg, mesh_cfg, mesh, spec_tree, storage0, wave_a, plan=plan)
        if wave_b:
            static1 = generate_static(cfg, mesh_cfg, mesh, spec_tree, storage1, wave_b,
                                      plan=plan)

    n_req = len(wave_a) + len(wave_b)
    total_new = sum(len(r.tokens) for r in results.values())
    ws = router.wire_summary()
    lines.append(f"{cfg.name}: {n_req} requests over {args.replicas} replicas / {args.workers} "
                 f"workers, prompts {min(lens)}..{max(lens)}, +{args.gen} tokens, "
                 f"page_size={args.page_size}" + (", int8 KV" if plan.int8_kv else ""))
    lines.append(f"fleet: {ws['ticks']} ticks in {wall:.2f}s "
                 f"({total_new / max(wall, 1e-9):.1f} tok/s) on {device}")
    lines.append(f"fabric: kv_migration {ws['kv_migration']} B over "
                 f"{ws['hops']['kv_migration']} hops ({ws['migrated_pages']} pages), "
                 f"weight_publish {ws['weight_publish']} B over {ws['publish_installs']} installs")
    by_replica: dict[str, int] = {}
    for meta in router.placements.values():
        by_replica[meta["replica"]] = by_replica.get(meta["replica"], 0) + 1
    lines.append(f"placement: {dict(sorted(by_replica.items()))}")
    analytic = fleet_migration_bytes(
        plan, cfg, page_size=args.page_size, migrated_pages=ws["migrated_pages"],
        int8_kv=plan.int8_kv, dtype_bytes=plan.compute_dtype.itemsize,
        publish_wire_bytes=parcel0.nbytes, publish_installs=ws["publish_installs"])
    for cls in ("kv_migration", "weight_publish"):
        if ws[cls] != analytic[cls]:
            out["error"] = (f"fleet fabric DIVERGED from the analytic model on {cls}: "
                            f"measured {ws[cls]} != analytic {analytic[cls]} (rank {rank})")
            return out
    lines.append(f"fabric == fleet_migration_bytes: kv {analytic['kv_migration']} B at "
                 f"{analytic['kv_width']} B/elem, publish {analytic['weight_publish']} B — "
                 "measured equals analytic")
    if args.check_static:
        bad = [r.rid for r in wave_a if results[r.rid].tokens != static0[r.rid]]
        bad += [r.rid for r in wave_b if results[r.rid].tokens != static1[r.rid]]
        if bad:
            out["error"] = (f"fleet vs static token streams DIVERGED for requests {bad} "
                            f"(rank {rank})")
            return out
        lines.append(f"check-static: {n_req} streams bit-exact vs the static reference"
                     + (" (v0 and v1 waves)" if wave_b else ""))
    for r in (wave_a + wave_b)[:4]:
        lines.append(f"  req{r.rid}: {results[r.rid].tokens[:16]}")
    return out


def main(argv=None, *, params=None, params1=None):
    """Run the launcher; returns rank 0's ``{rid: GenResult}``. ``params`` /
    ``params1`` replace the seeded weights of version 0 / 1 (port LM trees
    at the mesh's ``tp``, e.g. converted reference weights)."""
    args = build_parser().parse_args(argv)
    mesh_cfg = parse_mesh(args.mesh)
    if mesh_cfg.trivial:
        outs = [_fleet(0, args, params, params1)]
    else:
        world = mesh_cfg.dshards * mesh_cfg.tp
        resolve_device(args.device)  # a missing card fails here, not in the ranks
        threads = 1 if args.device == "cpu" else max(1, (os.cpu_count() or 1) // world)
        outs = spawn_ranks(_fleet, world, args, params, params1, threads=threads)
    for line in outs[0]["lines"]:
        print(line)
    for o in outs:
        if o["error"] is not None:
            raise SystemExit(o["error"])
    return outs[0]["results"]


if __name__ == "__main__":
    main()
