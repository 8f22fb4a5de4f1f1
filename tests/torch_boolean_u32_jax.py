"""The JAX side of the 32-bit boolean parity tests (tests/test_torch_boolean.py,
test_torch_seeded.py, test_torch_public_key.py, test_torch_serialization.py):
keys at TEST_PARAMS_BOOLEAN_U32 (key choice `small`, PBS → KS) and its
KS → PBS twin, drawn by the port's own generators at 32 bits and carried to
the JAX package as the dropped uint32 words (its NTT key made from them,
jitted), and tfhe_tpu.boolean with its two primitives
(`programmable_bootstrap`, `keyswitch_lwe`) jitted once at log_q = 32 on
rows padded to ROWS.  At this width the JAX key has no paired form, so its
PBS is the XLA `blind_rotate`, the rotate-subtract form the port's "rotate"
route runs on K7."""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tfhe_tpu.boolean as JB
from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.algorithms import external_product_num_primes as jax_num_primes
from tfhe_tpu.core.algorithms import keyswitch_lwe as jax_keyswitch
from tfhe_tpu.core.algorithms import programmable_bootstrap as jax_pbs
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import GlweSecretKey as JGlweSk
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.entities import LweSecretKey as JLweSk
from tfhe_tpu.core.params import TEST_PARAMS_BOOLEAN_U32 as JP
from tfhe_tpu.core.poly.ntt import get_plan as jax_plan
from tfhe_tpu_torch import boolean as B
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core import rng
from tfhe_tpu_torch.core.algorithms import (generate_bootstrap_key, generate_glwe_secret_key,
                                            generate_keyswitch_key, generate_lwe_secret_key)
from tfhe_tpu_torch.core.numeric import to_numpy_torus
from tfhe_tpu_torch.core.params import TEST_PARAMS_BOOLEAN_U32 as P

U32 = np.uint32
ROWS = 32
ORDERS = {"pbs_ks": (P, JP),
          "ks_pbs": (dataclasses.replace(P, name="TEST_PARAMS_BOOLEAN_U32_KS_PBS",
                                         encryption_key_choice="big"),
                     dataclasses.replace(JP, name="TEST_PARAMS_BOOLEAN_U32_KS_PBS",
                                         encryption_key_choice="big"))}


@jax.jit
def _jax_pbs_rows(data, acc, bsk):
    return jax_pbs(JLwe(data=data), JGlwe(data=acc), bsk, 32).data


@jax.jit
def _jax_ks_rows(data, ksk):
    return jax_keyswitch(JLwe(data=data), ksk, 32).data


def _padded(fn):
    """fn on rows [ROWS, n+1] → the same call on any batch of up to ROWS."""
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
def jitted_boolean():
    """tfhe_tpu.boolean with its two primitives jitted once at 32 bits on
    padded rows; restored afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "programmable_bootstrap",
                   _padded(lambda d, acc, bsk, log_q: _jax_pbs_rows(d, acc.data, bsk)))
        mp.setattr(JB, "keyswitch_lwe", _padded(lambda d, ksk, log_q: _jax_ks_rows(d, ksk)))
        yield


@functools.lru_cache(maxsize=None)
def keys(seed: int = 11) -> dict:
    """Secret bits (int8), the standard BSK and the KSK as the JAX package
    holds them at 32 bits (uint32), drawn by the port at log_q = 32; the
    JAX NTT key made from the BSK and its primes."""
    gen = rng.generator(seed, 32, device="cpu")
    lwe = generate_lwe_secret_key(gen, P.lwe_dimension)
    glwe = generate_glwe_secret_key(gen, P.glwe_dimension, P.polynomial_size)
    bsk = generate_bootstrap_key(gen, lwe, glwe, P.pbs_decomp, P.glwe_noise_std, 32)
    ksk = generate_keyswitch_key(gen, glwe.as_lwe_secret_key(), lwe, P.ks_decomp,
                                 P.lwe_noise_std, 32)
    npr = jax_num_primes(P.polynomial_size, P.glwe_size, JP.pbs_decomp, 32)
    bsk32 = to_numpy_torus(bsk.data, 32)
    jbsk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 32, npr))(
        jnp.asarray(bsk32))
    return dict(lwe_bits=lwe.bits.numpy().astype(np.int8),
                glwe_bits=glwe.bits.numpy().astype(np.int8),
                big_bits=glwe.bits.numpy().reshape(-1).astype(np.int8),
                bsk=bsk32, ksk=to_numpy_torus(ksk.data, 32), jbsk=jbsk,
                primes=jax_plan(P.polynomial_size, npr).primes)


def client_keys(k: dict, order: str) -> tuple:
    """(port ClientKey on the CPU, JAX ClientKey) of one order, same bits."""
    p, jp = ORDERS[order]
    tck = B.ClientKey(lwe_sk=interop.lwe_secret_key(k["lwe_bits"], device="cpu"),
                      glwe_sk=interop.glwe_secret_key(k["glwe_bits"], device="cpu"), params=p)
    jck = JB.ClientKey(lwe_sk=JLweSk(bits=jnp.asarray(k["lwe_bits"])),
                       glwe_sk=JGlweSk(bits=jnp.asarray(k["glwe_bits"])), params=jp)
    return tck, jck


def servers(k: dict, order: str) -> tuple:
    """(port ServerKey on the CPU through interop, JAX ServerKey)."""
    p, jp = ORDERS[order]
    jsk = JB.ServerKey(bsk=k["jbsk"], ksk=JKsk(data=jnp.asarray(k["ksk"]), decomp=jp.ks_decomp),
                       params=jp)
    tsk = interop.boolean_server_key(k["ksk"], np.asarray(k["jbsk"].data), k["primes"], p,
                                     device="cpu")
    return tsk, jsk


def enc_bits(k: dict, order: str) -> np.ndarray:
    return k["lwe_bits"] if ORDERS[order][0].encryption_key_choice == "small" else k["big_bits"]


def _noise32(rng_, shape, std):
    return np.round(rng_.normal(0.0, std, size=shape)).astype(np.int64).astype(U32)


def encrypt_bool(k: dict, order: str, msgs, seed: int) -> np.ndarray:
    """Boolean encryptions [B, n+1] uint32 of msgs under the order's key."""
    p = ORDERS[order][0]
    bits = enc_bits(k, order)
    r = np.random.default_rng(seed)
    pts = np.where(np.asarray(msgs), U32(1 << 29), U32(7 << 29))
    mask = r.integers(0, 2 ** 32, pts.shape + bits.shape, dtype=U32)
    std = p.lwe_noise_std if p.encryption_key_choice == "small" else p.glwe_noise_std
    body = (mask * bits.astype(U32)).sum(axis=-1, dtype=U32) + pts + _noise32(r, pts.shape, std)
    return np.concatenate([mask, body[..., None]], axis=-1)


def decrypt_bool(bits: np.ndarray, data: np.ndarray) -> np.ndarray:
    phase = data[..., -1] - (data[..., :-1] * bits.astype(U32)).sum(axis=-1, dtype=U32)
    return phase.astype(np.int32) > 0


def both(data: np.ndarray) -> tuple:
    return (interop.bool_ciphertext(data, device="cpu"),
            JB.BoolCiphertext(lwe=JLwe(data=jnp.asarray(data))))


def words(ct) -> np.ndarray:
    """A port BoolCiphertext's words as the JAX package holds them."""
    return to_numpy_torus(ct.lwe.data, ct.log_q)
