"""The JAX package's PBS as the port's parity tests run it, and both
packages' shortint server keys on the same numpy key (tests/torch_keys.py).

`interpreted_pbs()` runs the JAX PBS on its fused-kernel route (the delta
form the port's K1 computes, ROADMAP C4) in interpret mode, with every
call's rows padded to 16 or 64 (or a multiple of 64), so one jitted call a
row count serves the whole test.  It replaces the `programmable_bootstrap`
that `tfhe_tpu.shortint.server_key` and `tfhe_tpu.core.algorithms.wopbs`
call; inside a traced region (the integer divider's `lax.scan`) the call
goes through `jax.pure_callback`, so no kernel compiles there."""
import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tfhe_tpu.core.algorithms.wopbs as JW
import tfhe_tpu.shortint.server_key as JSS
from tfhe_tpu import config
from tfhe_tpu.core.algorithms import bootstrap as JBoot
from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.algorithms import external_product_num_primes as jax_num_primes
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu_torch import interop, shortint

_PBS = JBoot.programmable_bootstrap
_BUCKETS = (16, 64)


@jax.jit
def _rows(bsk, data, acc):
    """The JAX PBS on rows [R, n+1] with one LUT a row [R, k+1, N]."""
    return _PBS(JLwe(data=data), JGlwe(data=acc), bsk, 64).data


def _padded(bsk, flat, acc):
    rows = flat.shape[0]
    size = next((b for b in _BUCKETS if rows <= b), -(-rows // 64) * 64)
    flat = jnp.pad(jnp.asarray(flat), ((0, size - rows), (0, 0)))
    acc = jnp.pad(jnp.asarray(acc), ((0, size - rows), (0, 0), (0, 0)))
    return _rows(bsk, flat, acc)[:rows]


def padded_pbs(lwe, lut, bsk, log_q):
    """Drop-in for tfhe_tpu programmable_bootstrap: the same result, one
    jitted call a padded row count."""
    data = lwe.data
    lead, rows = data.shape[:-1], math.prod(data.shape[:-1])
    acc = jnp.broadcast_to(lut.data, lead + lut.data.shape[-2:]).reshape(
        (rows,) + lut.data.shape[-2:])
    flat = data.reshape(rows, data.shape[-1])
    width = (lut.data.shape[-2] - 1) * lut.data.shape[-1] + 1
    if isinstance(flat, jax.core.Tracer) or isinstance(acc, jax.core.Tracer):
        out = jax.pure_callback(lambda d, a: np.asarray(_padded(bsk, d, a)),
                                jax.ShapeDtypeStruct((rows, width), flat.dtype), flat, acc)
    else:
        out = _padded(bsk, flat, acc)
    return JLwe(data=out.reshape(lead + (width,)))


@contextlib.contextmanager
def interpreted_pbs():
    """The JAX PBS on its fused route in interpret mode, padded
    (`padded_pbs`), for the duration of the block."""
    old = (config.use_pallas_pbs(), config.pallas_interpret())
    config.set_use_pallas_pbs(True)
    config.set_pallas_interpret(True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JSS, "programmable_bootstrap", padded_pbs)
            mp.setattr(JW, "programmable_bootstrap", padded_pbs)
            yield
    finally:
        config.set_use_pallas_pbs(old[0])
        config.set_pallas_interpret(old[1])


def num_primes(params) -> int:
    return jax_num_primes(params.polynomial_size, params.glwe_dimension + 1, params.pbs_decomp,
                          64)


def jax_server(k, jparams, ksk=None, ks_decomp=None):
    """The JAX shortint ServerKey on the numpy key k (its BSK converted
    once, jitted), with k's KSK or `ksk`."""
    jbsk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=jparams.pbs_decomp), 64,
                                        num_primes(jparams)))(jnp.asarray(k["bsk"]))
    return JSS.ServerKey(ksk=JKsk(data=jnp.asarray(k["ksk"] if ksk is None else ksk),
                                  decomp=ks_decomp or jparams.ks_decomp),
                         bsk=jbsk, params=jparams)


def port_keys(k, params, ksk=None, ks_decomp=None):
    """The port's shortint (ClientKey, ServerKey) on the CPU on the numpy key
    k, with k's KSK or `ksk`."""
    tsk = shortint.ServerKey(
        ksk=interop.keyswitch_key(k["ksk"] if ksk is None else ksk,
                                  ks_decomp or params.ks_decomp, device="cpu"),
        bsk=interop.bootstrap_key_from_standard(k["bsk"], params.pbs_decomp,
                                                num_primes(params), device="cpu"),
        params=params)
    tck = shortint.ClientKey(glwe_sk=interop.glwe_secret_key(k["glwe_bits"], device="cpu"),
                             lwe_sk=interop.lwe_secret_key(k["lwe_bits"], device="cpu"),
                             params=params)
    return tck, tsk
