"""The port's encryption, trivial GLWE and sample extraction bit-exact
against tfhe_tpu on the same numpy-made masks and noise; the port's own
bootstrap and keyswitch keys decrypt to their gadget plaintexts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.core.algorithms.bootstrap import sample_extract as jax_sample_extract
from tfhe_tpu.core.algorithms.encryption import _glwe_mask_dot_key as jax_glwe_dot
from tfhe_tpu.core.algorithms.encryption import decrypt_lwe as jax_decrypt_lwe
from tfhe_tpu.core.algorithms.encryption import \
    encrypt_lwe_deterministic_mask as jax_encrypt_lwe
from tfhe_tpu.core.algorithms.encryption import trivial_glwe as jax_trivial_glwe
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweSecretKey as JLweSk
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core import rng
from tfhe_tpu_torch.core.algorithms import (decrypt_lwe, encrypt_glwe_deterministic_mask,
                                            encrypt_lwe_deterministic_mask,
                                            generate_bootstrap_key, generate_keyswitch_key,
                                            sample_extract, trivial_glwe)
from tfhe_tpu_torch.core.entities import GlweCiphertext, LweCiphertext
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from torch_keys import glwe_body

U64 = np.uint64
TOP = [2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1, 0]    # words with the top bit set, and edges


def _u64(rng_, shape):
    out = rng_.integers(0, 2 ** 64, shape, dtype=U64)
    out.reshape(-1)[:4] = TOP
    return out


def _noise(rng_, shape, std):
    return np.round(rng_.normal(0.0, std, size=shape)).astype(np.int64).view(U64)


def test_lwe_encryption_matches_jax():
    r = np.random.default_rng(21)
    n, B = P.lwe_dimension, 8
    bits = r.integers(0, 2, n).astype(np.int8)
    mask, pts = _u64(r, (B, n)), _u64(r, (B,))
    noise = _noise(r, (B,), 2.0 ** 40)
    ref = np.asarray(jax.jit(lambda m, s, p, e: jax_encrypt_lwe(m, JLweSk(bits=s), p, e, 64))(
        jnp.asarray(mask), jnp.asarray(bits), jnp.asarray(pts), jnp.asarray(noise)))
    sk = interop.lwe_secret_key(bits, device="cpu")
    ours = encrypt_lwe_deterministic_mask(from_numpy_u64(mask), sk, from_numpy_u64(pts),
                                          from_numpy_u64(noise))
    np.testing.assert_array_equal(to_numpy_u64(ours), ref)
    phase = np.asarray(jax.jit(lambda c, s: jax_decrypt_lwe(JLwe(data=c), JLweSk(bits=s), 64))(
        jnp.asarray(ref), jnp.asarray(bits)))
    np.testing.assert_array_equal(to_numpy_u64(decrypt_lwe(LweCiphertext(data=ours), sk)),
                                  phase)
    np.testing.assert_array_equal(phase, pts + noise)


def test_glwe_encryption_matches_jax():
    r = np.random.default_rng(22)
    k, N = P.glwe_dimension, P.polynomial_size
    bits = r.integers(0, 2, (k, N)).astype(np.int8)
    mask, pts = _u64(r, (3, k, N)), _u64(r, (3, N))
    noise = _noise(r, (3, N), 2.0 ** 30)
    dot = np.asarray(jax.jit(lambda m, s: jax_glwe_dot(m, s, 64))(jnp.asarray(mask),
                                                                 jnp.asarray(bits)))
    ours = encrypt_glwe_deterministic_mask(from_numpy_u64(mask),
                                           interop.glwe_secret_key(bits, device="cpu"),
                                           from_numpy_u64(pts), from_numpy_u64(noise))
    assert ours.shape == (3, k + 1, N)
    np.testing.assert_array_equal(to_numpy_u64(ours[:, :k]), mask)
    np.testing.assert_array_equal(to_numpy_u64(ours[:, k]), dot + pts + noise)
    np.testing.assert_array_equal(to_numpy_u64(ours[:, k]), glwe_body(mask, bits, pts, noise))


def test_trivial_glwe_matches_jax():
    r = np.random.default_rng(23)
    pts = _u64(r, (2, P.polynomial_size))
    ref = np.asarray(jax_trivial_glwe(jnp.asarray(pts), P.glwe_dimension, 64).data)
    ours = trivial_glwe(from_numpy_u64(pts), P.glwe_dimension)
    np.testing.assert_array_equal(to_numpy_u64(ours.data), ref)


@pytest.mark.parametrize("index", [0, 1, P.polynomial_size - 1])
def test_sample_extract_matches_jax(index):
    r = np.random.default_rng(24 + index)
    data = _u64(r, (3, P.glwe_dimension + 1, P.polynomial_size))
    ref = np.asarray(jax.jit(lambda d: jax_sample_extract(JGlwe(data=d), index).data)(
        jnp.asarray(data)))
    ours = sample_extract(GlweCiphertext(data=from_numpy_u64(data)), index)
    np.testing.assert_array_equal(to_numpy_u64(ours.data), ref)


def _signed(x: np.ndarray) -> np.ndarray:
    return x.view(np.int64)


def test_port_bootstrap_key_decrypts():
    """Every GLWE row of the port's BSK decrypts (numpy phase) to its GGSW
    plaintext, -s_i*g_l*S_r for r < k and s_i*g_l at the body, within noise."""
    k, N, L, Bl = P.glwe_dimension, P.polynomial_size, P.pbs_level, P.pbs_base_log
    lwe_bits = rng.binary_key(rng.generator(3, 1, device="cpu"), (P.lwe_dimension,))
    glwe_bits = rng.binary_key(rng.generator(3, 2, device="cpu"), (k, N))
    bsk = generate_bootstrap_key(rng.generator(3, 3, device="cpu"),
                                 interop.lwe_secret_key(lwe_bits, device="cpu"),
                                 interop.glwe_secret_key(glwe_bits, device="cpu"), P.pbs_decomp,
                                 P.glwe_noise_std)
    data = to_numpy_u64(bsk.data)                                  # [n, L, k+1, k+1, N]
    sbits, gbits = lwe_bits.numpy(), glwe_bits.numpy()
    phase = data[..., k, :] - glwe_body(data[..., :k, :], gbits, np.zeros(N, U64),
                                        np.zeros(N, U64))
    g = np.array([1 << (64 - Bl * (l + 1)) for l in range(L)], dtype=U64)
    lvl = sbits.astype(U64)[:, None] * g                           # [n, L]
    want = np.zeros(phase.shape, dtype=U64)
    want[:, :, :k, :] = U64(0) - lvl[:, :, None, None] * gbits.astype(U64)
    want[:, :, k, 0] = lvl
    err = np.abs(_signed(phase - want))
    assert err.max() < 16 * P.glwe_noise_std


def test_port_keyswitch_key_decrypts():
    """Every KSK row decrypts under the output key to s_in[i] * g_l, within
    noise."""
    n_in, L, Bk = 64, P.ks_level, P.ks_base_log
    in_bits = rng.binary_key(rng.generator(4, 1, device="cpu"), (n_in,))
    out_bits = rng.binary_key(rng.generator(4, 2, device="cpu"), (P.lwe_dimension,))
    out_sk = interop.lwe_secret_key(out_bits, device="cpu")
    ksk = generate_keyswitch_key(rng.generator(4, 3, device="cpu"),
                                 interop.lwe_secret_key(in_bits, device="cpu"),
                                 out_sk, P.ks_decomp, P.lwe_noise_std)
    assert ksk.data.shape == (n_in, L, P.lwe_dimension + 1)
    phase = to_numpy_u64(decrypt_lwe(LweCiphertext(data=ksk.data), out_sk))
    g = np.array([1 << (64 - Bk * (l + 1)) for l in range(L)], dtype=U64)
    want = in_bits.numpy().astype(U64)[:, None] * g
    err = np.abs(_signed(phase - want))
    assert err.max() < 16 * P.lwe_noise_std
    assert torch.unique(ksk.data[..., :-1]).numel() > n_in      # masks are not constant
