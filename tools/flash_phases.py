#!/usr/bin/env python3
"""Where the bf16 flash prefill kernel's time goes, phase by phase, per CTA.

    python3 tools/flash_phases.py [--shapes B,H,Kv,S ...]

Copies ``src/repro_torch/csrc/flash_prefill_bf16.cu`` and
``flash_common.cuh`` under ``build/flash_phases/``, inserts ``%globaltimer``
stamps (thread 0 of each CTA) at the kernel's phase boundaries, builds the
copy with ``nvcc`` and runs it through the port's wrapper at each shape
(B, H, Kv, S; Sq = Sk = S, q_offset 0). Prints, per item length in tiles,
the mean time from the CTA's start to its first tile's landing (Q and K_0),
the first tile's S and softmax, the remaining tiles of warpgroup 0's half,
the wait for warpgroup 1's half (and the exchange of halves), the epilogue
(warpgroup 0's columns merged and written, the output or the partial), and
for the last piece of a split unit each part of the merge; then the device
time of the stamped kernel in a CUDA graph.
The stamps cost a few stores a CTA; the checkout's kernel is unchanged.
Needs one NVIDIA GPU and ``nvcc`` (``/usr/local/cuda/bin`` or the PATH).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "flash_phases")
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
STAMP = "if (threadIdx.x == 0) g_stamps[blockIdx.x * 8 + {i}] = stamp_ns();\n"
MSTAMP = "  __syncthreads();\n  if (threadIdx.x == 0) g_merge[blockIdx.x * 4 + {i}] = stamp_ns();\n"
TIMER = """__device__ unsigned long long g_stamps[65536 * 8];
__device__ unsigned long long g_merge[65536 * 4];
__device__ __forceinline__ unsigned long long stamp_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
"""


def _insert(text, anchor, add, after=True):
    if anchor not in text:
        raise SystemExit(f"flash_phases: anchor not found in the kernel source: {anchor!r}")
    return text.replace(anchor, anchor + add if after else add + anchor, 1)


def stamped_sources():
    """(kernel source, header source) with the stamps in."""
    with open(os.path.join(CSRC, "flash_common.cuh")) as f:
        hdr = f.read()
    with open(os.path.join(CSRC, "flash_prefill_bf16.cu")) as f:
        src = f.read()
    hdr = _insert(hdr, "namespace flash {\n", TIMER)
    hdr = _insert(hdr, "  if (!last) return;\n", MSTAMP.format(i=0))
    hdr = _insert(hdr, "  for (int p = 0; p < mg.y; ++p) {\n    const size_t slot", MSTAMP.format(i=1),
                  after=False)
    hdr = _insert(hdr, "#pragma unroll\n  for (int i = 0; i < kRowsW; ++i)\n    store4(",
                  MSTAMP.format(i=2), after=False)
    hdr = _insert(hdr, "  if (threadIdx.x == 0) counters[item.w] = 0;", MSTAMP.format(i=3),
                  after=False)
    src = _insert(src, "  const int4 item = items[blockIdx.x];\n", "  " + STAMP.format(i=0))
    src = _insert(src, "  cp_async_wait<1>();  // Q (both warpgroups' copies) and K_0\n",
                  "  " + STAMP.format(i=1))
    src = _insert(src, "    softmax(0);\n", "    " + STAMP.format(i=2))
    src = _insert(src, "  cp_async_wait<0>();  // no copy outlives", "  " + STAMP.format(i=3),
                  after=False)
    src = _insert(src, "  if (wg == 0) give(32); else give(0);\n  __syncthreads();\n",
                  "  " + STAMP.format(i=5))
    src = _insert(src, "  if (part < 0) return;\n", "  " + STAMP.format(i=4), after=False)
    src += """
extern "C" int clear_stamps() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, flash::g_stamps);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(flash::g_stamps));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, flash::g_merge);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(flash::g_merge));
  return static_cast<int>(e);
}

extern "C" int read_stamps(void* dst, void* merge, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, flash::g_stamps, sizeof(unsigned long long) * 8 * n);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemcpyFromSymbol(merge, flash::g_merge,
                                               sizeof(unsigned long long) * 4 * n));
}
"""
    return src, hdr


def build():
    os.makedirs(OUT, exist_ok=True)
    src, hdr = stamped_sources()
    with open(os.path.join(OUT, "flash_common.cuh"), "w") as f:
        f.write(hdr)
    with open(os.path.join(OUT, "flash_prefill_bf16.cu"), "w") as f:
        f.write(src)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = os.path.join(OUT, "libflash_phases.so")
    subprocess.run([nvcc, "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, os.path.join(OUT, "flash_prefill_bf16.cu")],
                   check=True)
    return ctypes.CDLL(lib)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="*", default=["1,16,8,128", "1,16,8,512", "1,16,8,2048",
                                                     "1,8,4,512"])
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_prefill as fp

    if not torch.cuda.is_available():
        print("flash_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    lib = build()
    fn = lib.repro_flash_prefill_bf16
    fn.argtypes = kbuild._SIGNATURES["repro_flash_prefill_bf16"]
    fn.restype = ctypes.c_int
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    kbuild._LIB = types.SimpleNamespace(repro_flash_prefill_bf16=fn)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(1)
    for shape in args.shapes:
        B, H, Kv, S = map(int, shape.split(","))
        q, k, v = (torch.randn(s, generator=gen, device=device).to(torch.bfloat16)
                   for s in ((B, H, S, 128), (B, Kv, S, 128), (B, Kv, S, 128)))
        for _ in range(3):
            fp.flash_prefill(q, k, v)
        torch.cuda.synchronize()
        rc = lib.clear_stamps()  # one more launch, on stamps zeroed
        if rc:
            raise RuntimeError(f"clear_stamps: cudaError_t {rc}")
        fp.flash_prefill(q, k, v)
        torch.cuda.synchronize()
        _, items, merges, _ = fp.flash_work(B, H, Kv, S, S, 0, fp.SLOTS_BF16, fp.MIN_TILES_BF16)
        n = len(items)
        st, mg = np.zeros((n, 8), np.uint64), np.zeros((n, 4), np.uint64)
        rc = lib.read_stamps(st.ctypes.data, mg.ctypes.data, n)
        if rc:
            raise RuntimeError(f"read_stamps: cudaError_t {rc}")
        st, mg = st.astype(np.int64), mg.astype(np.int64)
        t0 = st[:, 0].min()
        us = (st[:, :6] - t0) / 1e3
        tiles = np.array([hi - lo for _, lo, hi, _, _ in items])
        last = mg[:, 3] > 0  # the pieces that merged their unit
        end = (np.where(last, mg[:, 3], st[:, 4]) - t0) / 1e3
        print(f"B={B} H={H} Kv={Kv} S={S}: {n} items, {len(merges)} merges; the last CTA ends "
              f"{end.max():.2f} us after the first one starts (us, means)")
        for nt in sorted(set(tiles)):
            d = us[tiles == nt]
            print(f"  {nt:2d} tiles x{len(d):3d}: first tile landed {np.mean(d[:, 1] - d[:, 0]):.2f}, "
                  f"its S + softmax {np.mean(d[:, 2] - d[:, 1]):.2f}, the rest of the half "
                  f"{np.mean(d[:, 3] - d[:, 2]):.2f}, the other half {np.mean(d[:, 5] - d[:, 3]):.2f}, "
                  f"epilogue {np.mean(d[:, 4] - d[:, 5]):.2f}")
        if last.any():
            d = (mg[last] - st[last, 4:5]) / 1e3
            print(f"  merging pieces x{int(last.sum())}: count and barriers {np.mean(d[:, 0]):.2f}, "
                  f"max of m {np.mean(d[:, 1] - d[:, 0]):.2f}, partials summed "
                  f"{np.mean(d[:, 2] - d[:, 1]):.2f}, output written {np.mean(d[:, 3] - d[:, 2]):.2f}")
        ms = cs.time_graph(torch, [lambda: fp.flash_prefill(q, k, v)], reps=10)
        print(f"  stamped kernel in a CUDA graph: {ms * 1e3:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
