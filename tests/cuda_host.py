"""Builds `tfhe_tpu_torch/csrc/rotation.cu`, `keyswitch.cu` and
`external_product.cu` for the host against `tests/cuda_host_stub.h`, for the
tests that run the kernels' CUDA source on the CPU
(tests/test_torch_delta_host.py, tests/test_torch_staged_host.py,
tests/test_torch_keyswitch_host.py, tests/test_torch_external_product.py,
tests/test_torch_pbs128.py)."""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from tfhe_tpu_torch import cuda_lib

TESTS = Path(__file__).resolve().parent


def build_rotation_host(out: Path, entries) -> ctypes.CDLL:
    """rotation.cu built with g++ (or clang++) into `out`, loaded, with the
    argument types of `entries` set from cuda_lib's table.  Skips where no
    C++20 host compiler is found."""
    # the cluster barrier's halves, which the stand-in models; other inline
    # PTX (programmatic dependent launch) has no meaning on the host
    return _build_host("rotation", out, entries, (
        ('asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");',
         "host_cluster_arrive();"),
        ('asm volatile("barrier.cluster.wait.aligned;" ::: "memory");', "host_cluster_wait();")))


def build_keyswitch_host(out: Path, entries) -> ctypes.CDLL:
    """keyswitch.cu built for the host, as `build_rotation_host`: the mma and
    cp.async statements become the stand-in's; cp.async's commit and wait
    have nothing to wait for there, as the stand-in's copy is synchronous."""
    src = (cuda_lib.CSRC / "keyswitch.cu").read_text()
    lines = [ln.strip() for ln in src.splitlines()]
    mma = next(ln for ln in lines if ln.startswith('asm volatile("mma.sync'))
    copy = next(ln for ln in lines if ln.startswith('asm volatile("cp.async.cg'))
    return _build_host("keyswitch", out, entries, (
        (mma, "host_mma_s8u8(d, a0, a1, a2, a3, b0, b1);"),
        (copy, "host_cp_async16(smem_dst, src, bytes);")))


def build_external_product_host(out: Path, entries) -> ctypes.CDLL:
    """external_product.cu (K7 and K8) built for the host, as
    `build_rotation_host`; it has no inline PTX."""
    return _build_host("external_product", out, entries, ())


def _build_host(name: str, out: Path, entries, replacements) -> ctypes.CDLL:
    """csrc/<name>.cu with the csrc headers it includes inlined, each (inline
    PTX statement, host call) of `replacements` replaced (each must be there
    once) and the rest of its inline PTX removed, compiled into `out` and
    loaded."""
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip(f"no C++ host compiler to build csrc/{name}.cu for the CPU")
    src = (cuda_lib.CSRC / f"{name}.cu").read_text()
    # the sources' own headers (csrc/*.cuh) inlined, so their text is built too
    src = re.sub(r'^#include "(\w+\.cuh)"$', lambda m: (cuda_lib.CSRC / m.group(1)).read_text(),
                 src, flags=re.M)
    src = src.replace("#include <cooperative_groups.h>", '#include "cuda_host_stub.h"')
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_host_stub.h"')
    for asm, call in replacements:
        assert src.count(asm) == 1, f"{name}.cu no longer has {asm!r} once"
        src = src.replace(asm, call)
    src = re.sub(r"^\s*asm volatile\(.*\);\s*$", "", src, flags=re.M)
    src = _static_shared(src)
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = host_smem;")
    (out / f"{name}.cpp").write_text(src)
    lib = out / f"lib{name}_host.so"
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                           "-Wno-unknown-pragmas", f"-I{TESTS}", "-o", str(lib),
                           str(out / f"{name}.cpp")], capture_output=True, text=True)
    if proc.returncode != 0:
        if "barrier" in proc.stderr and "No such file" in proc.stderr:
            pytest.skip(f"{cxx} has no C++20 <barrier>")
        raise AssertionError(f"host build of {name}.cu failed:\n{proc.stderr[-4000:]}")
    dll = ctypes.CDLL(str(lib))
    for entry in entries:
        getattr(dll, entry).argtypes = cuda_lib._SIGNATURES[entry]
        getattr(dll, entry).restype = ctypes.c_int
    return dll


def _static_shared(src: str) -> str:
    """Each kernel's `__shared__ T name[...];` arrays as references into the
    block's buffer, one after another (16-byte aligned), from its start."""
    out, offset = [], "0"
    for line in src.splitlines():
        if "__global__" in line:
            offset = "0"
        m = re.match(r"^(\s*)__shared__ ([\w:]+) (\w+)((?:\[[^\]]+\])+);\s*$", line)
        if m:
            indent, typ, name, dims = m.groups()
            line = (f"{indent}auto& {name} = *reinterpret_cast<{typ}(*){dims}>("
                    f"host_smem + {offset});")
            offset += f" + (sizeof({name}) + 15) / 16 * 16"
        out.append(line)
    return "\n".join(out) + "\n"
