"""How much dynamic shared memory will one block really get on this card?

Counterpart of `tools/vmem_probe.py` (its `probe`, whose pallas_call asks
Mosaic for an mb-sized VMEM scratch).  `probe(nbytes)` raises the kernel's
dynamic shared-memory limit to `nbytes` and launches one block that writes
and reads back every byte of it (`csrc/probe.cu`); `largest()` searches for
the largest size that launches and reads back right.  Its plain counterpart
is the CUDA device attribute, `optin_limit()`
(cudaDevAttrMaxSharedMemoryPerBlockOptin).  The rotation kernels size their
working set against `rotation._SMEM_LIMIT`; on an H100 all three agree.

    python -m tfhe_tpu_torch.smem_probe [KB ...]

sweeps sizes (default 48 to 256 KB) and stops at the first that fails, as
the TPU tool does.  Needs a CUDA card: there is no CPU version of a block's
shared memory.
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from . import cuda_lib

_REFUSED = 1          # cudaErrorInvalidValue: the runtime refused the size
_PATTERN_MUL, _PATTERN_ADD = 131, 7

# Probe kernel launches (sizes the runtime refused launch nothing).
launches = 0


def _expected_sum(nbytes: int) -> int:
    i = np.arange(nbytes, dtype=np.int64)
    return int(((i * _PATTERN_MUL + _PATTERN_ADD) & 0xFF).sum())


def _device(device) -> torch.device:
    dev = cuda_lib.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the shared-memory probe runs on a CUDA device, not {dev}")
    return dev


def probe(nbytes: int, device="cuda") -> bool:
    """True when one block launched with `nbytes` of dynamic shared memory
    and read back every byte it wrote; False when the runtime refused the
    size.  Any other CUDA error raises."""
    global launches
    dev = _device(device)
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        code = cuda_lib.library().tfhe_smem_probe(int(nbytes), out.data_ptr(),
                                                  cuda_lib.stream_of(out))
    if code == _REFUSED:
        return False
    launches += 1
    cuda_lib.check(code, "tfhe_smem_probe")
    return int(out.item()) == _expected_sum(int(nbytes))


def largest(device="cuda", hi: int = 1 << 18) -> int:
    """The largest nbytes <= hi for which `probe` holds (binary search;
    `probe` is monotone in nbytes)."""
    lo = 0                          # a block with no dynamic shared memory launches
    if not probe(lo, device):
        raise RuntimeError("the probe fails with no shared memory at all")
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if probe(mid, device):
            lo = mid
        else:
            hi = mid - 1
    return lo


def optin_limit(device="cuda") -> int:
    """The device attribute cudaDevAttrMaxSharedMemoryPerBlockOptin."""
    dev = _device(device)
    value = ctypes.c_int(0)
    code = cuda_lib.library().tfhe_smem_optin(dev.index or 0, ctypes.byref(value))
    cuda_lib.check(code, "tfhe_smem_optin")
    return value.value


def main(argv: list) -> int:
    sizes = [int(a) for a in argv] or [48, 64, 96, 128, 160, 192, 224, 227, 228, 256]
    print(f"device: {torch.cuda.get_device_name(0)}")
    for kb in sizes:
        ok = probe(kb * 1024)
        print(f"dynamic shared memory {kb} KB: {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            break
    print(f"largest that launched: {largest()} B; the device's opt-in attribute: "
          f"{optin_limit()} B")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
