"""The JAX side of the boolean parity tests (tests/test_torch_boolean.py,
tests/test_torch_apps.py): numpy keys for both packages at
TEST_PARAMS_BOOLEAN (key choice `small`, PBS → KS) and its KS → PBS twin,
and tfhe_tpu.boolean with its fused PBS in interpret mode, its two
primitives (`programmable_bootstrap`, `keyswitch_lwe`, the names the boolean
module calls) jitted once on rows padded to ROWS, so every gate of both
orders shares two compiles."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tfhe_tpu.boolean as JB
from tfhe_tpu import config
from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.algorithms import keyswitch_lwe as jax_keyswitch
from tfhe_tpu.core.algorithms import programmable_bootstrap as jax_pbs
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.params import TEST_PARAMS_BOOLEAN as JP
from tfhe_tpu.core.poly.ntt import get_plan as jax_plan
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core.algorithms import external_product_num_primes
from tfhe_tpu_torch.core.params import TEST_PARAMS_BOOLEAN as P
from torch_keys import _noise, real_keys

U64 = np.uint64
ROWS = 32
ORDERS = {"pbs_ks": (P, JP),
          "ks_pbs": (dataclasses.replace(P, name="TEST_PARAMS_BOOLEAN_KS_PBS",
                                         encryption_key_choice="big"),
                     dataclasses.replace(JP, name="TEST_PARAMS_BOOLEAN_KS_PBS",
                                         encryption_key_choice="big"))}


@jax.jit
def _jax_pbs_rows(data, acc, bsk):
    return jax_pbs(JLwe(data=data), JGlwe(data=acc), bsk, 64).data


@jax.jit
def _jax_ks_rows(data, ksk):
    return jax_keyswitch(JLwe(data=data), ksk, 64).data


def _padded(fn):
    """fn on rows [ROWS, n+1] → the same call on any batch of up to ROWS
    (rows are independent: zero rows pad the call)."""
    def call(lwe, *args):
        data = lwe.data
        batch, width = data.shape[:-1], data.shape[-1]
        flat = data.reshape(-1, width)
        rows = flat.shape[0]
        assert rows <= ROWS
        out = fn(jnp.pad(flat, ((0, ROWS - rows), (0, 0))), *args)[:rows]
        return JLwe(data=out.reshape(batch + out.shape[-1:]))
    return call


@contextlib.contextmanager
def interpret_boolean():
    """tfhe_tpu.boolean with its fused PBS in interpret mode and its two
    primitives jitted once on padded rows; restored afterwards."""
    old = (config.use_pallas_pbs(), config.pallas_interpret())
    config.set_use_pallas_pbs(True)
    config.set_pallas_interpret(True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "programmable_bootstrap",
                   _padded(lambda d, acc, bsk, log_q: _jax_pbs_rows(d, acc.data, bsk)))
        mp.setattr(JB, "keyswitch_lwe", _padded(lambda d, ksk, log_q: _jax_ks_rows(d, ksk)))
        yield
    config.set_use_pallas_pbs(old[0])
    config.set_pallas_interpret(old[1])


def numpy_keys(seed: int) -> dict:
    """real_keys at TEST_PARAMS_BOOLEAN, with the JAX NTT key made from them
    and its primes."""
    k = real_keys(P, seed=seed)
    npr = external_product_num_primes(P.polynomial_size, P.glwe_size, P.pbs_decomp)
    jbsk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, npr))(
        jnp.asarray(k["bsk"]))
    return dict(k, jbsk=jbsk, primes=jax_plan(P.polynomial_size, npr).primes)


def servers(keys, order):
    """(port ServerKey on the CPU, JAX ServerKey) of one order, from the
    same arrays: the port's through interop, from the JAX key's DIF data."""
    p, jp = ORDERS[order]
    jsk = JB.ServerKey(bsk=keys["jbsk"], ksk=JKsk(data=jnp.asarray(keys["ksk"]),
                                                  decomp=jp.ks_decomp), params=jp)
    tsk = interop.boolean_server_key(keys["ksk"], np.asarray(keys["jbsk"].data),
                                     keys["primes"], p, device="cpu")
    return tsk, jsk


def enc_bits(keys, order):
    p = ORDERS[order][0]
    return keys["lwe_bits"] if p.encryption_key_choice == "small" else keys["big_bits"]


def encrypt_bool(keys, order, msgs, seed):
    """Boolean encryptions [B, n+1] u64 of msgs under the order's key."""
    p = ORDERS[order][0]
    bits = enc_bits(keys, order)
    rng = np.random.default_rng(seed)
    pts = np.where(np.asarray(msgs), U64(1 << 61), U64(7 << 61))
    mask = rng.integers(0, 2 ** 64, pts.shape + bits.shape, dtype=U64)
    std = p.lwe_noise_std if p.encryption_key_choice == "small" else p.glwe_noise_std
    body = (mask * bits.astype(U64)).sum(axis=-1, dtype=U64) + pts + _noise(rng, pts.shape, std)
    return np.concatenate([mask, body[..., None]], axis=-1)


def decrypt_bool(bits, data):
    phase = data[..., -1] - (data[..., :-1] * bits.astype(U64)).sum(axis=-1, dtype=U64)
    return phase.astype(np.int64) > 0


def both(data):
    return (interop.bool_ciphertext(data, device="cpu"),
            JB.BoolCiphertext(lwe=JLwe(data=jnp.asarray(data))))
