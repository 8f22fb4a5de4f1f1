"""Runtime switches of the blind rotation (counterpart of the rotation
switches of `tfhe_tpu/config.py`).

The three switches read the JAX package's environment variables, with the
same defaults, so one deployment setting drives both packages alike.  Each
is read once, at first use, and can be overridden with its setter.  What
each means on the card:

  use_mxu_ntt()        TFHE_TPU_MXU, default on.  Off: classic keys are
                       converted into the *paired* form [GGSW(1 - s),
                       GGSW(s)] and every PBS on them runs the paired
                       per-step route (kernel K5 with g = 1).  Multi-bit
                       keys take the per-step route (K5).
  use_mxu_lanes()      TFHE_TPU_MXU_LANES, default off.  On: keys are
                       converted for the per-step route (K4 for classic
                       keys, K5 for multi-bit keys) whatever
                       `use_fused_rotation` says.
  use_fused_rotation() TFHE_TPU_FUSED, default on.  Read at PBS time: off
                       sends keys converted for the fused route to the
                       per-step route instead of the whole-rotation kernel
                       (K1 classic, K3 multi-bit).

A key records its route when it is converted (`NttBootstrapKey.route`,
`NttMultiBitBootstrapKey.route`), as the JAX keys record their spectral
order.  The TPU layouts these switches choose there (four-step matmul
NTTs, the batch folded into lanes, DIF butterflies) have no meaning on the
card: every route runs the same exact arithmetic, so the delta routes
agree bit for bit, and the paired route differs from them only in low bits
(the paired form decomposes the accumulator's rounded value into the
trivial gadget term).

`use_pallas_pbs`, `pallas_interpret` and `bucket_pbs_batch` have no
counterpart: the tensor's device decides between a kernel and its plain
version, and the kernels take any batch.
"""
from __future__ import annotations

import os
from typing import Optional

_OFF = ("0", "false", "False")


def _env_flag(name: str, default: bool) -> bool:
    env = os.environ.get(name)
    return env not in _OFF if env is not None else default


_USE_MXU: Optional[bool] = None
_MXU_LANES: Optional[bool] = None
_FUSED_ROTATION: Optional[bool] = None


def use_mxu_ntt() -> bool:
    """Off (TFHE_TPU_MXU=0): classic keys are converted into the paired
    form and run the paired per-step route.  Default on."""
    global _USE_MXU
    if _USE_MXU is None:
        _USE_MXU = _env_flag("TFHE_TPU_MXU", True)
    return _USE_MXU


def set_use_mxu_ntt(flag: bool):
    global _USE_MXU
    _USE_MXU = bool(flag)


def use_mxu_lanes() -> bool:
    """On (TFHE_TPU_MXU_LANES=1): keys are converted for the per-step
    route.  Default off."""
    global _MXU_LANES
    if _MXU_LANES is None:
        _MXU_LANES = _env_flag("TFHE_TPU_MXU_LANES", False)
    return _MXU_LANES


def set_use_mxu_lanes(flag: bool):
    global _MXU_LANES
    _MXU_LANES = bool(flag)


def use_fused_rotation() -> bool:
    """Whether a key converted for the fused route runs the whole rotation
    as one kernel launch (K1, K3); off (TFHE_TPU_FUSED=0) runs it one
    launch per step (K4, K5).  Default on."""
    global _FUSED_ROTATION
    if _FUSED_ROTATION is None:
        _FUSED_ROTATION = _env_flag("TFHE_TPU_FUSED", True)
    return _FUSED_ROTATION


def set_use_fused_rotation(flag: bool):
    global _FUSED_ROTATION
    _FUSED_ROTATION = bool(flag)
