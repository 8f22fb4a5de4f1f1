"""The paired route (TFHE_TPU_MXU=0) of the port against tfhe_tpu, at
TEST_PARAMS_SHORTINT (n=16, N=256, P=4) and its multi-bit copies (g=2,
n=16; g=3, n=18):

  * the paired classic key [GGSW(1 - s), GGSW(s)]: built from a standard
    key and carried across from JAX `bootstrap_key_to_ntt_paired`, checked;
  * the paired per-step rotation (K5 with g = 1, plain path on CPU) against
    `blind_rotate_pallas(mxu=False)` (B6) in interpret mode;
  * that output differs from the delta form's in low bits and decrypts to
    the same LUT values (hazard C4);
  * shortint `apply_lookup_table` on the paired route against JAX's under
    TFHE_TPU_MXU=0;
  * the multi-bit per-step rotation against `multi_bit_blind_rotate_pallas`
    with mxu=False (B6 on the DIF key).

Tolerance 0 wherever outputs are compared: the arithmetic is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import config as jconfig
from tfhe_tpu.core.algorithms import bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.algorithms.encryption import bootstrap_key_to_ntt_paired as jax_to_paired
from tfhe_tpu.core.algorithms.encryption import trivial_ggsw_one_ntt as jax_trivial_one
from tfhe_tpu.core.algorithms.multi_bit import multi_bit_bootstrap_key_to_ntt as jax_mb_to_ntt
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import LweBootstrapKey as JBsk
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.core.poly.pallas_ntt import blind_rotate_pallas, multi_bit_blind_rotate_pallas
from tfhe_tpu.shortint.ciphertext import Ciphertext as JCt
from tfhe_tpu.shortint.server_key import LookupTable as JLut
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu_torch import config, interop, shortint
from tfhe_tpu_torch.core.algorithms import programmable_bootstrap
from tfhe_tpu_torch.core.algorithms.encryption import trivial_ggsw_one_ntt
from tfhe_tpu_torch.core.entities import GlweCiphertext, LweCiphertext, NttBootstrapKey
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import MultiBitPBSParameters
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.poly import ntt, rotation
from torch_keys import (decrypt_big, encrypt_big, multi_bit_params, random_bsk,
                        random_multi_bit_bsk, real_keys)

U64 = np.uint64
N, R, NPR = P.polynomial_size, P.glwe_size, 4
SPACE = P.message_modulus * P.carry_modulus
DELTA = (1 << 64) // (2 * SPACE)
PRIMES = ntt.primes_for(N)[:NPR]
# One JAX call per rotation, at batch 8 with per-element LUTs whose first
# three rows are equal; each port case reads a slice of it.
CASES = {8: (slice(0, 8), True), 6: (slice(2, 8), True), 3: (slice(0, 3), False)}


def _inputs(n_in, seed):
    rng = np.random.default_rng(seed)
    lwe = rng.integers(0, 2 ** 64, (8, n_in + 1), dtype=U64)
    lwe[0, :3] = [2 ** 64 - 1, 2 ** 63, 0]
    lut = rng.integers(0, 2 ** 64, (8, R, N), dtype=U64)
    lut[1:3] = lut[0]
    return lwe, lut


def _hold_cases(rotate, key, lwe, lut, ref):
    for batch, (rows, per_element) in CASES.items():
        lt = lut[rows] if per_element else lut[0]
        out = rotate(from_numpy_u64(lt), from_numpy_u64(lwe[rows]), key)
        assert out.shape == (batch, R, N)
        np.testing.assert_array_equal(to_numpy_u64(out), ref[rows], err_msg=f"batch {batch}")


@pytest.fixture(scope="module")
def paired():
    std = random_bsk(P, 21)
    jkey = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, NPR))(
        jnp.asarray(std))
    pd, ps = jax.jit(lambda k: jax_to_paired(k, 64))(jkey)
    return dict(std=std, pd=np.asarray(pd), ps=ps,
                from_std=interop.paired_bootstrap_key_from_standard(std, P.pbs_decomp, NPR,
                                                                    device="cpu"),
                from_dif=interop.paired_bootstrap_key_from_dif(np.asarray(pd), PRIMES,
                                                               P.pbs_decomp, device="cpu"))


def test_paired_keys(paired):
    key = paired["from_std"]
    assert isinstance(key, NttBootstrapKey) and key.paired and key.route == "paired"
    assert key.spectra.shape == (P.lwe_dimension, 2, NPR, 2, R, N)
    np.testing.assert_array_equal(key.spectra.numpy(), paired["from_dif"].spectra.numpy())
    g1 = trivial_ggsw_one_ntt(N, R, P.pbs_decomp, NPR)
    np.testing.assert_array_equal(g1.numpy(), np.asarray(
        jax_trivial_one(N, R, JP.pbs_decomp, NPR, 64)).astype(np.int64))
    p = torch.tensor(PRIMES, dtype=torch.int64).reshape(NPR, 1, 1, 1)
    s = key.spectra.to(torch.int64)
    assert torch.equal((s[:, 0] + s[:, 1]) % p, g1.expand_as(s[:, 0]) % p)
    bad = paired["pd"].copy()
    bad[3, 0, 1, 0, 0, 7] ^= 1
    with pytest.raises(ValueError, match="pair0"):
        interop.paired_bootstrap_key_from_dif(bad, PRIMES, P.pbs_decomp, device="cpu")
    with pytest.raises(ValueError, match="primes"):
        interop.paired_bootstrap_key_from_dif(paired["pd"], ntt.PRIMES_HIGH_N[:NPR],
                                              P.pbs_decomp, device="cpu")
    with pytest.raises(ValueError, match="K1 takes a delta key"):
        rotation.rotate_accumulator(torch.zeros((1, R, N), dtype=torch.int64),
                                    torch.zeros((1, P.lwe_dimension), dtype=torch.int64), key)


def test_paired_rotation_matches_jax(paired):
    """B6, classic: `blind_rotate_pallas(mxu=False)` on the paired key."""
    lwe, lut = _inputs(P.lwe_dimension, seed=13)
    ref = np.asarray(jax.jit(lambda lt, lw, d, s: blind_rotate_pallas(
        lt, lw, d, s, JP.pbs_decomp, block_b=8, interpret=True, mxu=False))(
        jnp.asarray(lut), jnp.asarray(lwe), jnp.asarray(paired["pd"]), paired["ps"]))
    before = rotation.step_variant_launches
    for name in ("from_std", "from_dif"):
        _hold_cases(rotation.blind_rotate_steps, paired[name], lwe, lut, ref)
    assert rotation.step_variant_launches == before      # CPU tensors take the plain path


def test_paired_differs_from_delta_in_low_bits():
    """C4: on one real key, the paired and the delta rotations give PBS
    outputs that differ bit for bit but whose phases differ by far less
    than the message step, so both decrypt to the LUT's values."""
    keys = real_keys(P, seed=37)
    rng = np.random.default_rng(3)
    msgs = np.arange(SPACE, dtype=U64)
    mask = rng.integers(0, 2 ** 64, (SPACE, P.lwe_dimension), dtype=U64)
    noise = np.round(rng.normal(0, P.lwe_noise_std, SPACE)).astype(np.int64).view(U64)
    body = (mask * keys["lwe_bits"].astype(U64)).sum(axis=-1, dtype=U64) + msgs * U64(DELTA)
    lwe = LweCiphertext(data=from_numpy_u64(np.concatenate([mask, (body + noise)[:, None]], 1)))
    delta_key = interop.bootstrap_key_from_standard(keys["bsk"], P.pbs_decomp, NPR,
                                                    device="cpu")
    paired_key = interop.paired_bootstrap_key_from_standard(keys["bsk"], P.pbs_decomp, NPR,
                                                            device="cpu")
    assert (delta_key.route, paired_key.route) == ("fused", "paired")
    f = lambda x: (5 * x + 3) % SPACE
    lut = shortint.ServerKey(ksk=None, bsk=delta_key, params=P).generate_lookup_table(f).acc
    outs = [to_numpy_u64(programmable_bootstrap(lwe, lut, k).data)
            for k in (delta_key, paired_key)]
    assert not np.array_equal(outs[0], outs[1])
    for out in outs:
        np.testing.assert_array_equal(decrypt_big(P, keys["big_bits"], out), f(msgs))
    phases = [o[:, -1] - (o[:, :-1] * keys["big_bits"].astype(U64)).sum(-1, dtype=U64)
              for o in outs]
    diff = (phases[0] - phases[1]).view(np.int64)
    assert np.abs(diff).max() < DELTA // 16


@jax.jit
def _jax_apply(sk, data, acc):
    ct = JCt(lwe=JLwe(data=data), degree=SPACE - 1, message_modulus=4, carry_modulus=4)
    return sk.apply_lookup_table(ct, JLut(acc=JGlwe(data=acc), degree=0)).lwe.data


def test_paired_apply_lookup_table_matches_jax(monkeypatch):
    """Both packages convert the same key with MXU off (JAX: the "dif"
    paired key, PBS by the B6 kernel; the port: the paired key, PBS by the
    paired per-step route) and serve one LUT, bit for bit."""
    for mod in (config, jconfig):
        monkeypatch.setattr(mod, "_USE_MXU", False)
    monkeypatch.setattr(jconfig, "_USE_PALLAS", True)
    monkeypatch.setattr(jconfig, "_PALLAS_INTERPRET", True)
    keys = real_keys(P, seed=31)
    jbsk = jax.jit(lambda d: jax_to_ntt(JBsk(data=d, decomp=JP.pbs_decomp), 64, NPR))(
        jnp.asarray(keys["bsk"]))
    assert jbsk.paired_order == "dif"
    jsk = JServerKey(ksk=JKsk(data=jnp.asarray(keys["ksk"]), decomp=JP.ks_decomp), bsk=jbsk,
                     params=JP)
    tsk = shortint.ServerKey(
        ksk=interop.keyswitch_key(keys["ksk"], P.ks_decomp, device="cpu"),
        bsk=interop.bootstrap_key_from_standard(keys["bsk"], P.pbs_decomp, NPR, device="cpu"),
        params=P)
    assert tsk.bsk.route == "paired"
    f = lambda x: (3 * x + 1) % SPACE
    msgs = np.arange(SPACE)
    data = encrypt_big(P, keys["big_bits"], msgs, seed=1)
    ref = np.asarray(_jax_apply(jsk, jnp.asarray(data), jsk.generate_lookup_table(f).acc.data))
    np.testing.assert_array_equal(decrypt_big(P, keys["big_bits"], ref), f(msgs))
    ct = shortint.Ciphertext(lwe=LweCiphertext(data=from_numpy_u64(data)), degree=SPACE - 1)
    out = tsk.apply_lookup_table(ct, tsk.generate_lookup_table(f))
    np.testing.assert_array_equal(to_numpy_u64(out.lwe.data), ref)


@pytest.mark.parametrize("g,n_in", [(2, 16), (3, 18)], ids=["g2", "g3"])
def test_multi_bit_steps_match_jax_dif(g, n_in):
    """B6, multi-bit: `multi_bit_blind_rotate_pallas(mxu=False)` on the
    u32 DIF key that JAX builds with MXU off, carried across as the port's
    key (`multi_bit_bootstrap_key_from_dif`)."""
    tp = multi_bit_params(MultiBitPBSParameters, P, g, n_in)
    std = random_multi_bit_bsk(tp, 40 + g)
    jkey = jax.jit(lambda d: jax_mb_to_ntt(d, JP.pbs_decomp, g, 64))(jnp.asarray(std))
    lwe, lut = _inputs(n_in, seed=20 + g)
    ref = np.asarray(jax.jit(lambda lt, lw, d, s: multi_bit_blind_rotate_pallas(
        lt, lw, d, s, JP.pbs_decomp, g, block_b=8, interpret=True, mxu=False))(
        jnp.asarray(lut), jnp.asarray(lwe), jkey.data.astype(jnp.uint32),
        jkey.shoup.astype(jnp.uint32)))
    key = interop.multi_bit_bootstrap_key_from_dif(np.asarray(jkey.data), PRIMES,
                                                   tp.pbs_decomp, g, device="cpu")
    _hold_cases(rotation.multi_bit_blind_rotate_steps, key, lwe, lut, ref)
