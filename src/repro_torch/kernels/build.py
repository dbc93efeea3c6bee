"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` into an object file; the objects link into ONE shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
``src/repro_torch/_build/`` under a name that hashes every file under
``csrc/`` and the flags, so an edited source or header rebuilds and an
unchanged tree loads at once.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["CSRC_DIR", "BUILD_DIR", "SOURCES", "NVCC_FLAGS", "library",
           "load_built", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("predicate.cu", "filter_compact.cu", "bitset_ops.cu",
           "segment_scan.cu", "swa_attention.cu", "swa_prefill.cu",
           "swa_decode.cu", "swa_backward.cu", "swa_backward_wide.cu",
           "swa_backward_bf16.cu", "hash_partition.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_STATE: dict = {"lib": None, "info": None}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int


def _nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


def _digest() -> str:
    """Hash of the flags and of every file under ``csrc/`` (the sources and
    the headers they include)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC_DIR.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(CSRC_DIR)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _library_path() -> Path:
    return BUILD_DIR / f"librepro_kernels_{_digest()}.so"


def _build() -> dict:
    so = _library_path()
    # nvcc's output (ptxas's reports) is kept beside the library it built
    log_path = so.with_suffix(".log")
    if so.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(so), "seconds": 0.0, "built": False, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = [], []
        for name, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp_so, *objs], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log = "\n".join(logs)
        log_path.write_text(log)
        os.replace(tmp_so, so)
    return {"path": str(so), "seconds": time.perf_counter() - t0,
            "built": True, "log": log}


def _declare(lib: ctypes.CDLL) -> None:
    # args, valid, n, rows, grid, smem_bytes, words, count, stream
    lib.repro_predicate_bitset.argtypes = [_P, _P, _I64, _I32, _I32, _I32, _P,
                                           _P, _P]
    lib.repro_predicate_bitset.restype = _I32
    # rows, smem_bytes, blocks_per_sm, sm_count
    lib.repro_predicate_occupancy.argtypes = [_I32, _I32, _P, _P]
    lib.repro_predicate_occupancy.restype = _I32
    lib.repro_word_popcount.argtypes = [_P, _I64, _P, _P]
    lib.repro_word_popcount.restype = _I32
    lib.repro_compact_scatter.argtypes = [_P, _P, _P, _I64, _I64, _P]
    lib.repro_compact_scatter.restype = _I32
    # args, mask, n, count, workspace, vec16, stream
    lib.repro_mask_compact.argtypes = [_P, _P, _I64, _P, _P, _I32, _P]
    lib.repro_mask_compact.restype = _I32
    # keys, words, n, n_dest, block, dest, rank, hist, stream
    lib.repro_hash_partition.argtypes = [_P, _P, _I64, _I32, _I32, _P, _P, _P,
                                         _P]
    lib.repro_hash_partition.restype = _I32
    # args, grid, stream
    lib.repro_bitset_expr.argtypes = [_P, _I32, _P]
    lib.repro_bitset_expr.restype = _I32
    # n_ops, sm_count, blocks_per_sm
    lib.repro_bitset_expr_limits.argtypes = [_I32, _P, _P]
    lib.repro_bitset_expr_limits.restype = _I32
    # words, vals, n, block, lo, hi, ws, min, max, count, vec16, stream
    lib.repro_segmented_scan.argtypes = [_P, _P, _I64, _I64, _I32, _I32, _P,
                                         _P, _P, _P, _I32, _P]
    lib.repro_segmented_scan.restype = _I32
    # q, k, v, o; 12 strides; B, Hq, Hkv, Sq, Skv, D, causal, window;
    # q_offset; kv_len, is_bf16; lse; stream
    lib.repro_flash_attention.argtypes = ([_P] * 4 + [_I64] * 12 + [_I32] * 8
                                          + [_I64, _I32, _I32, _P, _P])
    lib.repro_flash_attention.restype = _I32
    # q, k, v, o; 12 strides; B, Hq, Hkv, Sq, D, causal, window; q_offset;
    # kv_len, start, chunk, splits, key_end; part; lse; vec16, is_bf16,
    # out_f32; stream
    lib.repro_flash_decode.argtypes = ([_P] * 4 + [_I64] * 12 + [_I32] * 7
                                       + [_I64] + [_I32] * 5 + [_P, _P]
                                       + [_I32] * 3 + [_P])
    lib.repro_flash_decode.restype = _I32
    # q, k, v, o, dout, dq, dk, dv, lse, delta; 24 strides; B, Hq, Hkv, Sq,
    # Skv, D, causal, window; q_offset; kv_len; stream (fp32 and bf16)
    for fn in (lib.repro_flash_attention_bwd,
               lib.repro_flash_attention_bwd_bf16):
        fn.argtypes = [_P] * 10 + [_I64] * 24 + [_I32] * 8 + [_I64, _I32, _P]
        fn.restype = _I32
    lib.repro_flash_attention_bwd_bf16_tiles.argtypes = [_I32, _P]
    lib.repro_flash_attention_bwd_bf16_tiles.restype = _I32
    lib.repro_flash_f32_tiles.argtypes = [_I32, _P]
    lib.repro_flash_f32_tiles.restype = _I32


def _load(info: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(info["path"])
    _declare(lib)
    _STATE["info"], _STATE["lib"] = info, lib
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    with _LOCK:
        if _STATE["lib"] is None:
            _load(_build())
        return _STATE["lib"]


def load_built() -> ctypes.CDLL:
    """Load the library another process already built from these sources;
    raise instead of building (the ranks of a sharded run load the parent's
    build and never start ``nvcc`` themselves)."""
    with _LOCK:
        if _STATE["lib"] is None:
            so = _library_path()
            if not so.exists():
                raise RuntimeError(
                    f"kernel library {so} is not built: call "
                    f"build.library() before spawning the ranks")
            _load({"path": str(so), "seconds": 0.0, "built": False,
                   "log": ""})
        return _STATE["lib"]


def build_info() -> Optional[dict]:
    """``{"path", "seconds", "built", "log"}`` of the loaded library, or
    None before the first ``library()`` call."""
    return _STATE["info"]


def check(status: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
