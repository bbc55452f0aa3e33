"""Build and load the port's hand-written CUDA kernels at first use.

The sources are ``repro_torch/csrc/*.cu``: plain C entry points with no
PyTorch headers, so ``nvcc`` compiles each in seconds. They are built
through ``torch.utils.cpp_extension.load`` (ninja runs one ``nvcc`` per
source in parallel) for ``sm_90a`` into ``build/torch_ext/`` at the root
of the checkout, a directory ``.gitignore`` lists, and the resulting
shared library is bound with ``ctypes``.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``. A build or load failure raises; there is no
fallback to the plain PyTorch versions. :func:`workspace` keeps the
scratch buffers that the attention kernels reuse from call to call.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (
    "bitpack.cu", "bitunpack.cu", "flash_prefill.cu", "flash_prefill_bf16.cu",
    "flash_attn_bwd.cu", "paged_attend.cu", "l2norm.cu",
)
BUILD_DIR = _PKG.parent.parent / "build" / "torch_ext"
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
)
LIB_NAME = "repro_torch_kernels"

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of every C entry point
_SIGNATURES = {
    "repro_bitpack": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "repro_bitunpack": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ],
    # (q, k, v, out, items, n_items, merges, counters, part_acc, part_ml,
    #  B, H, Kv, Gc, Sq, Sk, q_offset, scale, stream)
    "repro_flash_prefill_bf16": [
        _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        ctypes.c_float, _P,
    ],
    # the same with lse (B, H, Sq) or null after out
    "repro_flash_prefill": [
        _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        ctypes.c_float, _P,
    ],
    # (q, k, v, out, dout, lse, dq, dk, dv, delta, dq_part, qoff, items,
    #  n_items, merges, counters, kv_part, B, H, Kv, Sq, Sk, q_offset, scale,
    #  stream)
    "repro_flash_attn_bwd": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, ctypes.c_float, _P,
    ],
    # (q, k_pool, v_pool, page_table, lengths, out, part_acc, part_ml,
    #  counters, B, Kv, G, P, page, n_pages, n_splits, pps, scale, stream)
    "repro_paged_attend": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        ctypes.c_float, _P,
    ],
    # (w, partials, max_parts, out, n, stream)
    "repro_l2norm_sq": [_P, _P, _I, _P, ctypes.c_longlong, _P],
}
# the bf16 paged kernel takes the fp32 one's arguments
_SIGNATURES["repro_paged_attend_bf16"] = _SIGNATURES["repro_paged_attend"]

_LIB: ctypes.CDLL | None = None
# (name, device, stream) -> a kernel's workspace
_WORKSPACE: dict = {}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call of the process."""
    global _LIB
    if _LIB is None:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = load(
            name=LIB_NAME,
            sources=[str(CSRC / s) for s in SOURCES],
            build_directory=str(BUILD_DIR),
            extra_cuda_cflags=list(NVCC_FLAGS),
            is_python_module=False,
        )
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check_launch(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")


def workspace(name: str, device: torch.device, stream: int, n: int,
              dtype: torch.dtype) -> torch.Tensor:
    """A buffer of at least ``n`` elements that kernel ``name`` keeps for
    its calls on ``stream`` (merge counters, partial results), zeroed when
    it is allocated. One buffer a stream, so the calls that share it run
    in stream order; a kernel that counts in it leaves it zeroed."""
    key = (name, device, stream)
    buf = _WORKSPACE.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=dtype, device=device)
        _WORKSPACE[key] = buf
    return buf
