"""Serving launcher on one GPU (twin of ``repro.launch.serve``):
continuous batching over the slotted (default) or block-paged
(``--paged``) KV cache, with the static one-shot path as the reference
(``--check-static``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --prompt-lens 512,512,384,256,200 --gen 16 --max-slots 2 \\
      [--weight-stationary] [--check-static] [--reduced] [--device cpu] \\
      [--paged [--page-size 64] [--num-pages N] [--no-share-prefix]] \\
      [--shared-prefix N]

Weights are random, from seed 0 (``repro_torch.models.init``); the plan
is ``PrecisionPlan.build(round_to=2)``, the reference launcher's default
(bf16 planes). ``--shared-prefix N`` prepends N common tokens to every
prompt. Runs on ``cuda`` unless ``--device cpu``. The reference
launcher's speculative, sampling, window, int8-KV, mesh, plan-file,
precision and checkpoint options are not ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import fp32_math, resolve_device
from repro_torch.configs.registry import ARCHS, get_config, reduced
from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_storage
from repro_torch.models.init import init_params
from repro_torch.plan import PrecisionPlan
from repro_torch.roofline.analysis import serve_host_device_bytes
from repro_torch.serve.engine import Request, ServeEngine, generate_static


def build_requests(prompt_lens, gen: int, vocab_size: int, *,
                   shared_prefix: int = 0) -> list[Request]:
    """Greedy requests with prompts drawn from ``default_rng(0)``, as the
    reference launcher draws them: first ``shared_prefix`` tokens common to
    every prompt, then each prompt's own ``prompt_lens[i]`` tokens (with no
    prefix the prompts are the same as without the option)."""
    rng = np.random.default_rng(0)
    shared = tuple(int(t) for t in rng.integers(0, vocab_size, shared_prefix))
    return [
        Request(rid=i, max_new=gen, prompt_ids=shared + tuple(
            int(t) for t in rng.integers(0, vocab_size, S)))
        for i, S in enumerate(prompt_lens)
    ]


def setup(cfg, *, seed: int, device, mesh_cfg: MeshCfg | None = None):
    """``(mesh_cfg, spec_tree, storage)`` for random weights from ``seed``."""
    mesh_cfg = mesh_cfg or MeshCfg()
    params, metas = init_params(cfg, seed, device=device)
    spec_tree = build_spec_tree(params, metas, mesh_cfg)
    return mesh_cfg, spec_tree, tree_to_storage(params, spec_tree, mesh_cfg)


def check_wire(engine: ServeEngine, plan, requests) -> dict:
    """The engine's measured host<->device bytes must equal the analytic
    serve model for the run's geometry; returns the analytic table."""
    summary = engine.wire_summary()
    analytic = serve_host_device_bytes(
        plan, engine.cfg.vocab_size, n_slots=engine.max_slots,
        prompt_lens=[len(r.prompt_ids) for r in requests],
        decode_steps=summary["decode_steps"],
        page_table_entries=summary.get("page_table_entries", 0),
    )
    if summary["host_device"] != analytic["total"]:
        raise SystemExit(f"measured host_device {summary['host_device']} B != "
                         f"analytic {analytic['total']} B ({analytic})")
    return analytic


def check_streams(results, static_streams, requests) -> None:
    bad = [r.rid for r in requests if results[r.rid].tokens != static_streams[r.rid]]
    if bad:
        raise SystemExit(f"continuous vs static token streams DIVERGED for requests {bad}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt-lens", default="64,48,64,32",
                    help="comma-separated per-request prompt lengths")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-slots", type=int, default=0,
                    help="KV slots resident in the engine (default min(4, requests))")
    ap.add_argument("--weight-stationary", action="store_true")
    ap.add_argument("--check-static", action="store_true",
                    help="also run the static reference and require equal streams")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV layout: page pool + per-slot page table, "
                         "shared-prefix pages refcounted")
    ap.add_argument("--page-size", type=int, default=64, help="tokens per KV page (--paged)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page-pool size (default: slots x table width)")
    ap.add_argument("--no-share-prefix", action="store_true",
                    help="disable shared-prefix page interning (--paged)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many common tokens to every prompt")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    fp32_math()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mesh_cfg, spec_tree, storage = setup(cfg, seed=0, device=device)
    plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2)
    requests = build_requests([int(s) for s in args.prompt_lens.split(",")], args.gen,
                              cfg.vocab_size, shared_prefix=args.shared_prefix)
    lens = [len(r.prompt_ids) for r in requests]
    slots = args.max_slots or min(4, len(requests))
    cap = max(lens) + args.gen

    static_streams = None
    if args.check_static:
        t0 = time.perf_counter()
        static_streams = generate_static(cfg, mesh_cfg, None, spec_tree, storage,
                                         requests, plan=plan)
        print(f"static one-shot reference: {len(requests)} requests in "
              f"{time.perf_counter() - t0:.2f}s")
    engine = ServeEngine(cfg, mesh_cfg, None, spec_tree, storage, plan=plan,
                         max_slots=slots, cache_capacity=cap,
                         weight_stationary=args.weight_stationary, paged=args.paged,
                         page_size=args.page_size, num_pages=args.num_pages or None,
                         share_prefix=not args.no_share_prefix)
    t0 = time.perf_counter()
    results = engine.run(requests)
    wall = time.perf_counter() - t0
    total_new = sum(len(r.tokens) for r in results.values())
    summary = engine.wire_summary()
    analytic = check_wire(engine, plan, requests)
    print(f"{cfg.name} on {device}: {len(requests)} requests, prompts "
          f"{min(lens)}..{max(lens)}, +{args.gen} tokens, {slots} slots")
    print(f"engine: {summary['steps']} steps ({summary['decode_steps']} decode) in "
          f"{wall:.2f}s ({total_new / max(wall, 1e-9):.1f} tok/s)")
    print(f"host_device wire: {summary['host_device']} B staged at "
          f"{summary['token_width']} B/token == serve_host_device_bytes "
          f"{analytic['total']} B")
    if args.paged:
        res = engine.kv_residency()
        audit = engine.pages.audit()
        print(f"paged KV: page_size={res['page_size']}, {audit['allocs']} page allocs / "
              f"{audit['releases']} releases, peak {res['pages_peak']} pages resident "
              f"({res['kv_bytes_peak']} B at {res['bytes_per_page']} B/page)")
        print(f"paged prefill: {summary['prefill_misses']} bucket lengths first seen, "
              f"{summary['prefill_hits']} seen before; page-table staging "
              f"{summary['page_table']} B")
    for r in requests[:4]:
        print(f"  req{r.rid}: {results[r.rid].tokens[:16]}")
    if static_streams is not None:
        check_streams(results, static_streams, requests)
        print(f"check-static: {len(requests)} streams equal to the static reference")
    return results


if __name__ == "__main__":
    main()
