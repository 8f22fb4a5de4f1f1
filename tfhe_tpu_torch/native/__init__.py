"""Native (C++) components through ctypes (counterpart of
`tfhe_tpu/native/__init__.py`).

  * The AES-128-CTR tree-forkable CSPRNG (reference concrete-csprng):
    `csprng.cpp`, this package's own copy, whose streams are byte for byte
    the JAX package's for the same seed and fork indices.
  * The C ABI over `tfhe_tpu_torch.capi` (`capi.cpp`, header
    `include/tfhe_tpu.h`, the C API's own name): `build_capi()`.

Both build with g++ at first use, never at import, into
`tfhe_tpu_torch/build/` (not the package directory), each under a
per-process temporary name published by an atomic rename, and rebuild when
their source is newer.  Without g++ the first use raises.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD = _DIR.parent / "build"
_SO = BUILD / "libtfhe_tpu_torch_csprng.so"
_CAPI_SO = BUILD / "libtfhe_tpu_torch_capi.so"
INCLUDE = _DIR / "include"
_LIB = None


def _fresh(out: Path, *sources: Path) -> bool:
    return out.exists() and all(out.stat().st_mtime >= s.stat().st_mtime for s in sources)


def _compile(out: Path, args: list) -> Path:
    """g++ `args` into `out`, through a temporary name and a rename."""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp.{os.getpid()}.so")
    proc = subprocess.run(["g++", *args, "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"building {out.name} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_csprng() -> Path:
    """The CSPRNG's shared library, built if absent or stale."""
    src = _DIR / "csprng.cpp"
    if _fresh(_SO, src):
        return _SO
    return _compile(_SO, ["-O3", "-shared", "-fPIC", str(src)])


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_csprng()))
        lib.csprng_new.restype = ctypes.c_void_p
        lib.csprng_new.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.csprng_free.argtypes = [ctypes.c_void_p]
        lib.csprng_fill.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.csprng_fork.restype = ctypes.c_void_p
        lib.csprng_fork.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.csprng_aes_block.argtypes = [ctypes.c_char_p] * 3
        lib.csprng_aes_block_soft.argtypes = [ctypes.c_char_p] * 3
        lib.csprng_backend.restype = ctypes.c_int
        _LIB = lib
    return _LIB


class AesCtrGenerator:
    """Tree-forkable AES-CTR byte stream (reference `RandomGenerator`)."""

    def __init__(self, seed: bytes = None, _handle=None):
        lib = _lib()
        if _handle is not None:
            self._h = _handle
        else:
            if seed is None:
                seed = os.urandom(16)
            if len(seed) != 16:
                raise ValueError(f"an AES-128 seed is 16 bytes, not {len(seed)}")
            self._h = lib.csprng_new(seed, 0)
        self._lib = lib

    def generate(self, n: int) -> bytes:
        buf = ctypes.create_string_buffer(n)
        self._lib.csprng_fill(self._h, buf, n)
        return buf.raw

    def fork(self, child_index: int = 0) -> "AesCtrGenerator":
        """The deterministic child stream `child_index` (reference fork tree)."""
        return AesCtrGenerator(_handle=self._lib.csprng_fork(self._h, child_index))

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.csprng_free(h)


def aes128_encrypt_block(key: bytes, block: bytes) -> bytes:
    """One AES-128 block (FIPS-197 test vectors)."""
    out = ctypes.create_string_buffer(16)
    _lib().csprng_aes_block(key, block, out)
    return out.raw


def aes128_encrypt_block_soft(key: bytes, block: bytes) -> bytes:
    """The portable software twin of aes128_encrypt_block."""
    out = ctypes.create_string_buffer(16)
    _lib().csprng_aes_block_soft(key, block, out)
    return out.raw


def backend() -> str:
    """The live AES backend: "aesni" (hardware, detected at run time) or
    "soft"."""
    return "aesni" if _lib().csprng_backend() == 1 else "soft"


def build_capi() -> Path:
    """libtfhe_tpu_torch_capi.so: the C ABI over `tfhe_tpu_torch.capi`,
    embedding CPython (header `include/tfhe_tpu.h`, `INCLUDE`; a C client
    links it with -ltfhe_tpu_torch_capi)."""
    src, header = _DIR / "capi.cpp", INCLUDE / "tfhe_tpu.h"
    if _fresh(_CAPI_SO, src, header):
        return _CAPI_SO
    inc = sysconfig.get_paths()["include"]
    ver = sysconfig.get_config_var("LDVERSION")
    libdir = sysconfig.get_config_var("LIBDIR")
    return _compile(_CAPI_SO, ["-O2", "-shared", "-fPIC", str(src), f"-I{inc}",
                               f"-I{INCLUDE}", f"-L{libdir}", f"-Wl,-rpath,{libdir}",
                               f"-lpython{ver}"])


__all__ = ["AesCtrGenerator", "aes128_encrypt_block", "aes128_encrypt_block_soft", "backend",
           "build_csprng", "build_capi", "BUILD", "INCLUDE"]
