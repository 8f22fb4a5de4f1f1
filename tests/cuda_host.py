"""Builds `tfhe_tpu_torch/csrc/rotation.cu` for the host against
`tests/cuda_host_stub.h`, for the tests that run the rotation kernels' CUDA
source on the CPU (tests/test_torch_delta_host.py,
tests/test_torch_staged_host.py)."""
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
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ host compiler to build csrc/rotation.cu for the CPU")
    src = (cuda_lib.CSRC / "rotation.cu").read_text()
    src = src.replace("#include <cooperative_groups.h>", '#include "cuda_host_stub.h"')
    src = src.replace("#include <cuda_runtime.h>", "")
    # the cluster barrier's halves, which the stand-in models; other inline
    # PTX (programmatic dependent launch) has no meaning on the host
    for asm, call in (("barrier.cluster.arrive.relaxed.aligned;", "host_cluster_arrive();"),
                      ("barrier.cluster.wait.aligned;", "host_cluster_wait();")):
        line = f'asm volatile("{asm}" ::: "memory");'
        assert src.count(line) == 1, f"rotation.cu no longer has {line!r} once"
        src = src.replace(line, call)
    src = re.sub(r"^\s*asm volatile\(.*\);\s*$", "", src, flags=re.M)
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = host_smem;")
    (out / "rotation.cpp").write_text(src)
    lib = out / "librotation_host.so"
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                           "-Wno-unknown-pragmas", f"-I{TESTS}", "-o", str(lib),
                           str(out / "rotation.cpp")], capture_output=True, text=True)
    if proc.returncode != 0:
        if "barrier" in proc.stderr and "No such file" in proc.stderr:
            pytest.skip(f"{cxx} has no C++20 <barrier>")
        raise AssertionError(f"host build of rotation.cu failed:\n{proc.stderr[-4000:]}")
    dll = ctypes.CDLL(str(lib))
    for name in entries:
        getattr(dll, name).argtypes = cuda_lib._SIGNATURES[name]
        getattr(dll, name).restype = ctypes.c_int
    return dll
