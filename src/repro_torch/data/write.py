"""Shard-writer CLI (twin of ``repro.data.write``): the synthetic
generators written once into the tiered record format
(:mod:`repro_torch.data.shards`), after which training reads bytes from
disk as a production run does:

  PYTHONPATH=src python -m repro_torch.data.write --kind lm \\
      --vocab 151936 --seq 128 --records 256 --out shards/
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --data-dir shards/ --steps 20

Prints one JSON line: the directory, kind, records, shard files and the
stored bytes, which must equal the shard files' sizes.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.data.shards import write_feature_shards, write_lm_shards


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=["lm", "feature"], default="lm")
    ap.add_argument("--out", required=True)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--dim", type=int, default=64, help="feature dim (kind=feature)")
    ap.add_argument("--records", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--codec", choices=["zlib", "raw"], default="zlib")
    ap.add_argument("--records-per-shard", type=int, default=64)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    kw = dict(vocab=args.vocab, seq=args.seq, num_records=args.records, seed=args.seed,
              codec=args.codec, records_per_shard=args.records_per_shard)
    if args.kind == "lm":
        manifest = write_lm_shards(args.out, **kw)
    else:
        manifest = write_feature_shards(args.out, dim=args.dim, **kw)
    stored = sum(s for sh in manifest["shards"] for r in sh["records"]
                 for f in r["fields"].values() for s in f["plane_sizes"])
    files = [sh["file"] for sh in manifest["shards"]]
    on_disk = sum(os.path.getsize(os.path.join(args.out, f)) for f in files)
    if stored != on_disk:
        raise RuntimeError(f"manifest/shard byte mismatch: manifest says {stored}, "
                           f"files hold {on_disk}")
    out = {"out": args.out, "kind": args.kind, "records": args.records, "shards": len(files),
           "stored_bytes": stored}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
