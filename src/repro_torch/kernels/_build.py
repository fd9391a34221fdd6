"""Build and load the port's CUDA kernels.

On first use every ``repro_torch/csrc/*.cu`` is compiled by ``nvcc`` for
Hopper (``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per source,
all started together, then linked into ``build/repro_torch/libkernels.so``
at the repository root and loaded with ``ctypes``.  The sources export a
plain C interface, so no PyTorch header is compiled.  A stamp holding the
hash of the sources and flags skips the build when the library is current.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libkernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# exported C functions: name -> (argtypes, restype); the launch functions
# return the cudaError_t of their launch as an int
SIGNATURES = {
    # q, k, v, cache_len, out, part, tickets, B, S, H, Hkv, dh, window,
    # splits, rows_per_split, is_bf16, stream
    "repro_decode_attention": ([_P] * 7 + [_I] * 9 + [_P], _I),
    # tokens, mask, out, idx, count, ws (or NULL), B, S, row_bytes, K, tile,
    # n_tiles, chunks, stream
    "repro_masked_compact": ([_P] * 6 + [_I] * 7 + [_P], _I),
    # buf, wg, wu, wd, h (4-byte workspace [E,C,F]), out, counts (or NULL),
    # E, C, D, F, is_bf16, stream
    "repro_grouped_ffn": ([_P] * 7 + [_I] * 5 + [_P], _I),
    # decay, bx, h0, h_all, h_last, B, S, channels (= di * N), stream
    "repro_ssm_scan": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
            or "/usr/local/cuda"
        cand = Path(home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError(
            "cannot build the repro_torch CUDA kernels: nvcc was not found "
            "on PATH, under $CUDA_HOME/bin or /usr/local/cuda/bin")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _stamp(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _run_all(cmds):
    """Start every command at once, wait for all; raise with the failing
    commands' output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


def build() -> Path:
    """Compile the sources into ``BUILD_DIR/libkernels.so`` unless the stamp
    says the library is current.  Returns the library's path."""
    sources = _sources()
    stamp = _stamp(sources)
    lib_path = BUILD_DIR / LIB_NAME
    stamp_path = BUILD_DIR / "stamp"
    if lib_path.exists() and stamp_path.exists() \
            and stamp_path.read_text() == stamp:
        build_info.update(seconds=0.0, cached=True)
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [BUILD_DIR / (src.stem + ".o") for src in sources]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                    for src, obj in zip(sources, objs)])
    tmp = BUILD_DIR / (LIB_NAME + ".tmp")
    _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, lib_path)
    stamp_path.write_text(stamp)
    (BUILD_DIR / "ptxas.log").write_text(log)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      ptxas=log)
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use.  Raises, naming the
    cause, when there is no CUDA device or no ``nvcc``."""
    global _lib
    if _lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError("cannot launch the repro_torch CUDA kernels: "
                               "no CUDA device is available")
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = load().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
