"""GLWE x GLWE multiplication and the GSW entity of the port
(`core/algorithms/glwe_mult.py`, `core/algorithms/gsw.py`) against
`tfhe_tpu.core.algorithms.glwe_mult` and `.gsw`.

Bit for bit (tolerance 0) on the same uniform words (exactness needs no
encryption; words with the top bit set, hazard C1: the operands' shift is
logical): `glwe_mult` with its relinearization key at k = 1 and 2 and
log_p = 2, 4, 6 (the port rounds where JAX truncates, ROADMAP C12, so it
is held against JAX's function on words offset by 2^(shift-1)),
`gsw_external_product` and `cmux_lwe` batched; the JAX side jitted.  Then
the port alone: its relinearization key and GSW encryptions decrypt (m1*m2
after `glwe_mult`, m*pt after the GSW product, the CMux's selection), and
`glwe_mult` refuses an odd log_p as the reference does; at
AES_PARAMETERS_40's GLWE widths the port's rounding product decrypts every
row where the truncating shift of the JAX function fails (C12)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.core.algorithms import glwe_mult as JGM
from tfhe_tpu.core.algorithms import gsw as JGsw
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import GlweRelinearizationKey as JRlk
from tfhe_tpu.core.entities import GswCiphertext as JGswCt
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.params import DecompParams as JDecomp
from tfhe_tpu_torch.core import rng
from tfhe_tpu_torch.core.algorithms import glwe_mult as TGM
from tfhe_tpu_torch.core.algorithms import gsw as TGsw
from tfhe_tpu_torch.core.algorithms.encryption import (decrypt_glwe, decrypt_lwe, encrypt_glwe,
                                                       encrypt_lwe, generate_glwe_secret_key,
                                                       generate_lwe_secret_key)
from tfhe_tpu_torch.core.entities import (GlweCiphertext, GlweRelinearizationKey,
                                          GswCiphertext, LweCiphertext)
from tfhe_tpu_torch.core.numeric import as_i64, from_numpy_u64, shr, to_numpy_u64
from tfhe_tpu_torch.core.params import DecompParams

U64 = np.uint64
TOP = [0, 2 ** 63, 2 ** 64 - 1, 2 ** 63 - 1]


def words(rng_, shape):
    w = rng_.integers(0, 2 ** 64, shape, dtype=U64)
    w.reshape(-1)[:len(TOP)] = TOP
    return w


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _jax_glwe_mult(a, b, rlk, log_p, base_log, level):
    key = JRlk(data=rlk, decomp=JDecomp(base_log, level))
    return JGM.glwe_mult(JGlwe(data=a), JGlwe(data=b), key, log_p, 64).data


@pytest.mark.parametrize("k, n, base_log, level, log_p",
                         [(1, 256, 23, 1, 4), (2, 128, 8, 3, 2), (2, 64, 11, 2, 6)])
def test_glwe_mult_bit_exact(k, n, base_log, level, log_p):
    """The port's rounding switch (ROADMAP C12) on words w equals JAX's
    truncating one on w + 2^(shift-1) mod 2^64: JAX's glwe_mult reads its
    operands only through that shift.  The top-bit words carry out of the
    top there (the smaller torus wrapping)."""
    r = np.random.default_rng(k * 100 + log_p)
    a, b = words(r, (3, k + 1, n)), words(r, (3, k + 1, n))
    rlk = words(r, (k * (k + 1) // 2, level, k + 1, n))
    half = U64(1 << (32 - log_p // 2 - 1))
    want = np.asarray(_jax_glwe_mult(jnp.asarray(a + half), jnp.asarray(b + half),
                                     jnp.asarray(rlk), log_p, base_log, level))
    key = GlweRelinearizationKey(data=from_numpy_u64(rlk), decomp=DecompParams(base_log, level))
    got = TGM.glwe_mult(GlweCiphertext(data=from_numpy_u64(a)),
                        GlweCiphertext(data=from_numpy_u64(b)), key, log_p)
    np.testing.assert_array_equal(to_numpy_u64(got.data), want)


def test_pair_index():
    for i in range(4):
        for j in range(i + 1):
            assert TGM.pair_index(i, j) == JGM.pair_index(i, j)
    assert [TGM.pair_index(i, j) for i in range(3) for j in range(i + 1)] == list(range(6))


@pytest.mark.parametrize("k", [1, 2])
def test_own_relinearization_key_multiplies(k):
    """Port keys alone: m1*m2 mod 16 after glwe_mult at log_p = 4."""
    n, log_p, std = 256, 4, 2.0 ** -50 * 2.0 ** 64
    glwe_sk = generate_glwe_secret_key(rng.generator(3, k, device="cpu"), k, n)
    rlk = TGM.generate_relinearization_key(rng.generator(4, k, device="cpu"), glwe_sk,
                                           DecompParams(23, 1), std)
    assert tuple(rlk.data.shape) == (k * (k + 1) // 2, 1, k + 1, n)
    # each block decrypts to s_i*s_j * q/B
    bits = glwe_sk.bits
    for i in range(k):
        for j in range(i + 1):
            phase = decrypt_glwe(GlweCiphertext(data=rlk.data[TGM.pair_index(i, j), 0]), glwe_sk)
            sij = TGM.negacyclic_polymul(bits[i], bits[j], log_bound=10)
            err = phase - sij * as_i64(1 << 41)
            assert int(err.abs().max()) < 2 ** 20
    m1, m2 = torch.tensor([0, 3, 5, 15, 7]), torch.tensor([9, 3, 6, 15, 1])
    g = rng.generator(5, k, device="cpu")

    def enc(m):
        pts = torch.zeros((m.numel(), n), dtype=torch.int64)
        pts[:, 0] = m << (64 - log_p)
        return encrypt_glwe(g, glwe_sk, pts, std)

    prod = TGM.glwe_mult(enc(m1), enc(m2), rlk, log_p)
    phase = decrypt_glwe(prod, glwe_sk)[:, 0]
    got = ((phase + (1 << (63 - log_p))) >> (64 - log_p)) & ((1 << log_p) - 1)
    np.testing.assert_array_equal(got.numpy(), (m1 * m2).numpy() % 16)
    with pytest.raises(AssertionError):
        TGM.glwe_mult(enc(m1), enc(m2), rlk, 3)


@functools.lru_cache(maxsize=None)
def _jax_gsw_fns(base_log, level):
    d = JDecomp(base_log, level)
    prod = jax.jit(lambda g, c: JGsw.gsw_external_product(JGswCt(data=g, decomp=d),
                                                          JLwe(data=c), 64).data)
    cmux = jax.jit(lambda g, c0, c1: JGsw.cmux_lwe(JGswCt(data=g, decomp=d), JLwe(data=c0),
                                                   JLwe(data=c1), 64).data)
    return prod, cmux


@pytest.mark.parametrize("n, base_log, level", [(16, 4, 8), (20, 7, 3)])
def test_gsw_product_and_cmux_bit_exact(n, base_log, level):
    r = np.random.default_rng(n)
    g = words(r, (level, n + 1, n + 1))
    c0, c1 = words(r, (2, 3, n + 1)), words(r, (2, 3, n + 1))
    prod, cmux = _jax_gsw_fns(base_log, level)
    gsw = GswCiphertext(data=from_numpy_u64(g), decomp=DecompParams(base_log, level))
    got = TGsw.gsw_external_product(gsw, LweCiphertext(data=from_numpy_u64(c0)))
    np.testing.assert_array_equal(to_numpy_u64(got.data),
                                  np.asarray(prod(jnp.asarray(g), jnp.asarray(c0))))
    got = TGsw.cmux_lwe(gsw, LweCiphertext(data=from_numpy_u64(c0)),
                        LweCiphertext(data=from_numpy_u64(c1)))
    np.testing.assert_array_equal(
        to_numpy_u64(got.data),
        np.asarray(cmux(jnp.asarray(g), jnp.asarray(c0), jnp.asarray(c1))))


@pytest.mark.parametrize("bit", [0, 1])
def test_own_gsw_selects(bit):
    """Port keys alone: GSW(bit) [x] LWE(m) decrypts to bit*m, and the CMux
    picks ct1 where bit = 1, else ct0."""
    n, decomp, std = 32, DecompParams(4, 10), 2.0 ** -45 * 2.0 ** 64
    sk = generate_lwe_secret_key(rng.generator(1, device="cpu"), n)
    g = rng.generator(2, bit, device="cpu")
    gsw = TGsw.encrypt_constant_gsw(g, sk, bit, decomp, std)
    assert tuple(gsw.data.shape) == (decomp.level, n + 1, n + 1)
    m0, m1 = torch.tensor([1, 2, 3, 0]), torch.tensor([5, 6, 7, 4])
    ct0 = encrypt_lwe(g, sk, m0 << 60, std)
    ct1 = encrypt_lwe(g, sk, m1 << 60, std)

    def dec(ct):
        return ((decrypt_lwe(ct, sk) + (1 << 59)) >> 60) & 15

    np.testing.assert_array_equal(dec(TGsw.gsw_external_product(gsw, ct1)).numpy(),
                                  (bit * m1).numpy())
    np.testing.assert_array_equal(dec(TGsw.cmux_lwe(gsw, ct0, ct1)).numpy(),
                                  (m1 if bit else m0).numpy())


def test_truncating_modulus_switch_at_aes_widths(monkeypatch):
    """ROADMAP C12, repaired in the port: at AES_PARAMETERS_40's GLWE widths
    (k = 3, N = 512) the port's rounding switch decrypts every row of
    noiseless encryptions of m1, m2 mod 16.  The truncating shift of the
    JAX function (glwe_mult.py:59-62), put back by undoing the rounding
    offset, leaves a non-centred error that the tensor product multiplies
    by the phases' wrap counts, and most rows fail.  Noiseless keys and
    encryptions, the published PBS decomposition (6 x 4) for the
    relinearization key."""
    k, n, log_p, rows = 3, 512, 4, 16
    glwe_sk = generate_glwe_secret_key(rng.generator(11, device="cpu"), k, n)
    rlk = TGM.generate_relinearization_key(rng.generator(12, device="cpu"), glwe_sk,
                                           DecompParams(6, 4), 0.0)
    g = rng.generator(13, device="cpu")
    m1, m2 = torch.arange(rows) % 16, (torch.arange(rows) * 7 + 3) % 16

    def enc(m):
        pts = torch.zeros((rows, n), dtype=torch.int64)
        pts[:, 0] = m << (64 - log_p)
        return encrypt_glwe(g, glwe_sk, pts, 0.0)

    a, b = enc(m1), enc(m2)

    def right():
        phase = decrypt_glwe(TGM.glwe_mult(a, b, rlk, log_p), glwe_sk)[:, 0]
        got = ((phase + (1 << (63 - log_p))) >> (64 - log_p)) & 15
        return int((got == (m1 * m2) % 16).sum())

    assert right() == rows
    monkeypatch.setattr(TGM, "shr", lambda x, s: shr(x - (1 << (s - 1)), s))
    truncating = right()
    print(f"k = {k}, N = {n}: truncating shift {truncating}/{rows} right")
    assert truncating < rows // 2, truncating
