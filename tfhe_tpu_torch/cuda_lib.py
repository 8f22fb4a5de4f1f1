"""Build and load the port's CUDA kernels.

The sources under `csrc/` have a plain C interface (`ntt_passes.cuh`, the
passes K1/K4, K6 and K7/K8 share, is included by two of them).  At first
use each is compiled with `nvcc` for `sm_90a` into an object, all at once in parallel,
and the objects are linked into one shared library under `build/` (named by
a hash of the sources and flags), loaded with ctypes; nothing is built when
the package is imported.  If `nvcc` is missing or the build fails,
`library()` raises with the compiler's output: there is no fallback.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SOURCES = ("rotation.cu", "keyswitch.cu", "external_product.cu", "probe.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "tfhe_blind_rotate": [_P, _P, _P, _P, _P] + [_I] * 13 + [_P],
    "tfhe_blind_rotate_multi_bit": [_P, _P, _P, _P, _P] + [_I] * 12 + [_P],
    "tfhe_blind_rotate_step": [_P, _P, _L, _P, _P, _P] + [_I] * 12 + [_P],
    "tfhe_blind_rotate_step_variants": [_P, _P, _L, _P, _P, _P] + [_I] * 11 + [_P],
    "tfhe_staged_rotate": [_P, _P, _L, _I, _P, _P, _P, _P, _P] + [_I] * 14 + [_P],
    "tfhe_cluster_step": [_P, _P, _L, _I, _P, _P, _P] + [_I] * 15 + [_P],
    "tfhe_cluster_step_active": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "tfhe_variant_active_clusters": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "tfhe_delta_active_blocks": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    "tfhe_keyswitch_decompose": [_P, _L, _P] + [_I] * 6 + [_P],
    "tfhe_keyswitch_tc": [_P, _P, _P, _P] + [_I] * 6 + [_P],
    "tfhe_external_product": [_P, _L, _P, _L, _P, _L, _P, _L, _P, _P, _P] + [_I] * 13 + [_P],
    "tfhe_external_product128": [_P, _L, _P, _L, _P, _L, _P, _P, _P] + [_I] * 13 + [_P],
    "tfhe_smem_probe": [_I, _P, _P],
    "tfhe_smem_optin": [_I, ctypes.POINTER(ctypes.c_int)],
}

_lib = None
build_info: dict = {}      # command, seconds and compiler log of the last build


class BuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found on PATH or under $CUDA_HOME/bin: "
                     "the CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into build/ unless a library of the same sources
    and flags is there already; returns its path.  One nvcc per source, all
    started together, then one link."""
    nvcc = find_nvcc()
    srcs = [CSRC / s for s in SOURCES]
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        digest.update(s.read_bytes())
    out = BUILD / f"libtfhe_tpu_torch_{digest.hexdigest()[:16]}.so"
    if out.exists():
        build_info.update(path=str(out), cached=True)
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD / f"{s.stem}.{tag}.o" for s in srcs]
    t0 = time.perf_counter()
    cmds = [[nvcc, *FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    for cmd, proc, one in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise BuildError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{one}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    for o in objs:
        o.unlink()
    if proc.returncode != 0:
        raise BuildError(f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
                         f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(path=str(out), cached=False, seconds=time.perf_counter() - t0,
                      command="\n".join(" ".join(c) for c in cmds + [link]), log=log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tfhe_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tfhe_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().tfhe_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device.  Entry points default to the card and
    never fall back to the CPU: a CUDA device on a host without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} was asked for, but no CUDA device is "
                           f"available; pass device='cpu' to run on the CPU")
    return dev


def stream_of(tensor: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a raw handle.
    Kernels launch there, so the caching allocator reuses a temporary's
    memory only for work queued after the kernel."""
    return torch.cuda.current_stream(tensor.device).cuda_stream
