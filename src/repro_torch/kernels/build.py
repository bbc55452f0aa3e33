"""Build and load the port's hand-written CUDA kernels at first use.

The sources are ``repro_torch/csrc/*.cu``: plain C entry points with no
PyTorch headers, so ``nvcc`` compiles each in seconds. They are built
through ``torch.utils.cpp_extension.load`` (ninja runs one ``nvcc`` per
source in parallel) for ``sm_90a`` into ``build/torch_ext/`` at the root
of the checkout, a directory ``.gitignore`` lists, and the resulting
shared library is bound with ``ctypes``.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``. A build or load failure raises; there is no
fallback to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import pathlib

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("bitpack.cu", "bitunpack.cu", "flash_prefill.cu", "paged_attend.cu")
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
    # (q, k, v, out, B, H, Kv, Sq, Sk, q_offset, scale, stream)
    "repro_flash_prefill": [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P,
    ],
    # (q, k_pool, v_pool, page_table, lengths, out, B, Kv, G, P, page,
    #  n_pages, scale, stream)
    "repro_paged_attend": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P,
    ],
}

_LIB: ctypes.CDLL | None = None


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
