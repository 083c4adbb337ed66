"""Build and bind the port's CUDA kernels.

At first use, `nvcc` compiles every `csrc/*.cu` for `sm_90a` (one process a
source, all in parallel) and links them into one shared library with a plain
C interface, in `build/kernels/<hash>/` at the root of the checkout (listed
in `.gitignore`). The hash covers the sources and the flags, so an edited
source builds anew. No PyTorch header is included, so the build takes
seconds. The library is bound with `ctypes`: every pointer and the stream
are `c_void_p`, every launcher returns the `cudaError_t` of its launch, and
`check` raises on anything but 0.

`LAUNCHES` counts the launches of each kernel. Only a wrapper that has just
launched its kernel adds to it, so a run can show that it went through the
kernels: set the counts to 0 with `reset_launches()`, run, read them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES = {"rmsnorm": 0, "rmsnorm_residual": 0, "flash_attention": 0, "decode_attention": 0,
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)
# argtypes of each C entry point in csrc/ (the stream is the last argument of each launcher)
SIGNATURES = {
    # x, scale, y, rows, d, eps, dtype, the launch plan (elements per load,
    # lanes per row, rows per block, loads per thread), stream
    "launch_rmsnorm": [_P, _P, _P, _L, _I, _F, _I, _I, _I, _I, _I, _P],
    # x, res, scale, y, r, rows, d, eps, dtype, stream
    "launch_rmsnorm_residual": [_P, _P, _P, _P, _P, _L, _I, _F, _I, _P],
    # q, k, v, o, lse (null: none), B, Hq, Hkv, S, dh, q strides (b, h, s), k
    # strides, v strides, o strides, TMA boxes (dh columns, query rows, keys;
    # zeros: no TMA), window (<=0: none), scale, dtype, stream
    "launch_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
    + [_L] * 12 + [_I, _I, _I, _I, _F, _I, _P],
    # q, k, v, o, dout, lse, delta (scratch), dq, dk, dv, B, Hq, Hkv, S, dh,
    # the 24 (b, h, s) strides of q, k, v, o, dout, dq, dk, dv, TMA boxes (dh
    # columns, query rows, keys; zeros: no TMA), window, scale, dtype, stream
    "launch_flash_attention_bwd": [_P] * 10 + [_I] * 5 + [_LP, _I, _I, _I, _I, _F, _I, _P],
    # x, res (null: none), scale, dy, dr (null: none), dx, partial sums
    # (scratch), dscale, rows, d, eps, dtype, the launch plan (elements per
    # load, lanes per row, rows per block, loads per thread, blocks), stream
    "launch_rmsnorm_bwd": [_P] * 8 + [_L, _I, _F, _I] + [_I] * 5 + [_P],
    # q, k, v, o, lse (null: none), B, Hkv, G, T, dh, k strides (b, h, t), v
    # strides, n_valid, the launch plan (n_split, tiles per CTA, ring stages,
    # smem bytes, TMA box dh columns and slots, slot extent), scale, dtype, stream
    "launch_decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
    + [_L] * 6 + [_I] * 8 + [_F, _I, _P],
    # dtype, dh, n_split, smem bytes -> clusters of the decode kernel resident
    # at once (a negative cudaError_t on failure); launches nothing, no stream
    "decode_attention_max_active_clusters": [_I, _I, _I, _I],
}

DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile the kernels if needed: (library path, build seconds, nvcc log).

    One `nvcc -c` a source, all started together, then one link: the build
    takes as long as the slowest source, not their sum."""
    out_dir = BUILD_ROOT / _digest()
    lib, log = out_dir / "libkernels.so", out_dir / "nvcc.log"
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()  # another process may build the same sources at once
    nvcc, compile_flags = _nvcc(), [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources()]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *compile_flags, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    outputs = [proc.communicate()[0] for proc in procs]
    text = "".join(outputs)
    if any(proc.returncode for proc in procs):
        raise RuntimeError(f"nvcc failed:\n{text}")
    tmp = out_dir / f"libkernels.{tag}.so"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)], capture_output=True,
                          text=True)
    dt = time.perf_counter() - t0
    text += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to link ({proc.returncode}):\n{text}")
    for obj in objs:
        obj.unlink()
    log.write_text(text)
    os.replace(tmp, lib)  # atomic: another process building at once finds a whole library or none
    return lib, dt, text


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, built at the first call of the process."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {lib.error_string(err).decode()}")


def dtype_code(t) -> int:
    name = str(t.dtype).removeprefix("torch.")
    if name not in DTYPE_CODES:
        raise TypeError(f"dtype {t.dtype} is not supported by the kernels (float32, bfloat16)")
    return DTYPE_CODES[name]


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
