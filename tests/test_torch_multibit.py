"""Multi-bit PBS in the port against tfhe_tpu, at TEST_PARAMS_SHORTINT widths
(N=256) with grouping 2 (n=16) and 3 (n=18): the rotation (K3's plain path
on CPU) bit-exact against `blind_rotate_fused(..., mode="multibit")` in
interpret mode, with keys carried across both ways; the step formula in
Python integers; the port's multi-bit keygen; shortint KS+PBS end to end;
and the entry points' default device."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import config
from tfhe_tpu.core.algorithms.multi_bit import multi_bit_bootstrap_key_to_ntt as jax_to_ntt
from tfhe_tpu.core.entities import GlweCiphertext as JGlwe
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweKeyswitchKey as JKsk
from tfhe_tpu.core.params import MultiBitPBSParameters as JMultiBit
from tfhe_tpu.core.params import TEST_PARAMS_SHORTINT as JP
from tfhe_tpu.core.poly.pallas_ntt import blind_rotate_fused as jax_rotate
from tfhe_tpu.shortint.ciphertext import Ciphertext as JCt
from tfhe_tpu.shortint.server_key import LookupTable as JLut
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu_torch import interop, shortint
from tfhe_tpu_torch.core import rng
from tfhe_tpu_torch.core.algorithms import (bootstrap_key_to_ntt, external_product_num_primes,
                                            generate_multi_bit_bootstrap_key,
                                            multi_bit_bootstrap_key_to_ntt)
from tfhe_tpu_torch.core.algorithms.multi_bit import indicator_messages
from tfhe_tpu_torch.core.entities import (LweBootstrapKey, LweCiphertext,
                                          NttMultiBitBootstrapKey)
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import DecompParams, MultiBitPBSParameters
from tfhe_tpu_torch.core.params import TEST_PARAMS_SHORTINT as P
from tfhe_tpu_torch.core.poly import ntt, rotation
from torch_keys import (_negacyclic_matrix, decrypt_big, encrypt_big, int_external_product,
                        int_monomial, int_polymul, multi_bit_params, random_multi_bit_bsk,
                        real_multi_bit_keys)
from torch_keys import indicator_messages as np_indicator_messages

U64 = np.uint64
N, R = P.polynomial_size, P.glwe_size
SPACE = P.message_modulus * P.carry_modulus


LWE_DIM = {2: 16, 3: 18}
TP = {g: multi_bit_params(MultiBitPBSParameters, P, g, n) for g, n in LWE_DIM.items()}
JPM = {g: multi_bit_params(JMultiBit, JP, g, n) for g, n in LWE_DIM.items()}


def _jax_key(std, g):
    """JAX multi-bit key (four-step u32 copies and phase tables, as the
    package's default configuration builds them)."""
    key = jax.jit(lambda d: jax_to_ntt(d, JP.pbs_decomp, g, 64))(jnp.asarray(std))
    assert key.u32_order == "fourstep"
    return key


# ---------------------------------------------------------------------------
# (a) the rotation against blind_rotate_fused(mode="multibit")
# ---------------------------------------------------------------------------

# One JAX call per grouping, at batch 8 with per-element LUTs whose first
# three rows are equal; each port case reads a slice of it (ciphertexts are
# independent), so the port runs at batch 8 and 6 with per-element LUTs and
# at batch 3 with the shared LUT.
CASES = {8: (slice(0, 8), True), 6: (slice(2, 8), True), 3: (slice(0, 3), False)}


@pytest.fixture(scope="module", params=[2, 3], ids=["g2", "g3"])
def rot(request):
    g = request.param
    tp = TP[g]
    std = random_multi_bit_bsk(tp, 40 + g)
    jkey = _jax_key(std, g)
    npr = external_product_num_primes(N, R, tp.pbs_decomp)
    r = np.random.default_rng(g)
    lwe = r.integers(0, 2 ** 64, (8, tp.lwe_dimension + 1), dtype=U64)
    lwe[0, :3] = [2 ** 64 - 1, 2 ** 63, 0]
    lut = r.integers(0, 2 ** 64, (8, R, N), dtype=U64)
    lut[1:3] = lut[0]
    ref = np.asarray(jax.jit(lambda lt, lw, b, s, m, ms: jax_rotate(
        lt, lw, b, s, m, ms, JP.pbs_decomp, block_b=8, interpret=True,
        mode="multibit", grouping=g))(jnp.asarray(lut), jnp.asarray(lwe), jkey.data_u32,
                                      jkey.shoup_u32, jkey.mono, jkey.mono_shoup))
    from_std = interop.multi_bit_bootstrap_key_from_standard(std, tp.pbs_decomp, g, npr,
                                                             device="cpu")
    from_dif = interop.multi_bit_bootstrap_key_from_dif(
        np.asarray(jkey.data), ntt.primes_for(N)[:npr], tp.pbs_decomp, g, device="cpu")
    return dict(g=g, std=std, jkey=jkey, lwe=lwe, lut=lut, ref=ref,
                from_std=from_std, from_dif=from_dif)


@pytest.mark.parametrize("batch", sorted(CASES))
def test_multi_bit_rotation_matches_jax(rot, batch):
    rows, per_element = CASES[batch]
    lut = rot["lut"][rows] if per_element else rot["lut"][0]
    before = rotation.multi_bit_launches
    for route in ("from_std", "from_dif"):
        out = rotation.blind_rotate_fused_multi_bit(from_numpy_u64(lut),
                                                    from_numpy_u64(rot["lwe"][rows]),
                                                    rot[route])
        assert out.shape == (batch, R, N)
        np.testing.assert_array_equal(to_numpy_u64(out), rot["ref"][rows], err_msg=route)
    assert rotation.multi_bit_launches == before      # CPU tensors take the plain path


def test_multi_bit_key_routes_agree(rot):
    key = rot["from_std"]
    assert isinstance(key, NttMultiBitBootstrapKey)
    assert key.spectra.shape == (LWE_DIM[rot["g"]] // rot["g"], 1 << rot["g"], 4, 2, R, N)
    assert (key.grouping_factor, key.input_lwe_dimension) == (rot["g"], LWE_DIM[rot["g"]])
    np.testing.assert_array_equal(key.spectra.numpy(), rot["from_dif"].spectra.numpy())
    with pytest.raises(ValueError, match="primes"):
        interop.multi_bit_bootstrap_key_from_dif(np.asarray(rot["jkey"].data),
                                                 ntt.PRIMES_HIGH_N[:4], P.pbs_decomp,
                                                 rot["g"], device="cpu")


# ---------------------------------------------------------------------------
# (b) the step formula in Python integers
# ---------------------------------------------------------------------------


def _naive_multi_bit_step(acc, cs, ggsws, decomp):
    """acc = sum_v X^{c_v} * sum_{l,r} decomp_l(acc_r) * GGSW_v[l, r]
    mod (X^N + 1, 2^64), with c_0 = 0."""
    n = len(acc[0])
    out = [[0] * n for _ in acc]
    for c_v, ggsw in zip(cs, ggsws):
        total = int_external_product(acc, ggsw, decomp)
        mono = int_monomial(c_v, n)
        out = [[o + v for o, v in zip(out[c], int_polymul(mono, total[c]))]
               for c in range(len(acc))]
    return [[x % 2 ** 64 for x in row] for row in out]


@pytest.mark.parametrize("g", [2, 3])
def test_plain_multi_bit_rotation_is_the_step_formula(g):
    """K3's contract at N=16, two levels, two steps: the variants' exponents
    (MSB of v = the group's first mask element) and the replacing step."""
    n_poly, steps, levels = 16, 2, 2
    decomp = DecompParams(base_log=7, level=levels)
    r = np.random.default_rng(10 + g)
    std = r.integers(0, 2 ** 64, (steps, 1 << g, levels, R, R, n_poly), dtype=U64)
    key = interop.multi_bit_bootstrap_key_from_standard(std, decomp, g, 4, device="cpu")
    acc = r.integers(0, 2 ** 64, (2, R, n_poly), dtype=U64)
    exps = r.integers(0, 2 * n_poly, (2, steps * g))
    exps[0, :g] = [2 * n_poly - 1] + [n_poly] * (g - 1)      # the sums wrap mod 2N
    out = rotation.rotate_accumulator_multi_bit(
        from_numpy_u64(acc), rotation.variant_exponents(torch.from_numpy(exps), g, n_poly),
        key)
    for b in range(2):
        ref = [[int(x) for x in row] for row in acc[b]]
        for j in range(steps):
            grp = exps[b, j * g:(j + 1) * g]
            cs = [sum(int(grp[i]) for i in range(g) if (v >> (g - 1 - i)) & 1) % (2 * n_poly)
                  for v in range(1 << g)]
            ggsws = [[[[[int(x) for x in std[j, v, l, rr, c]] for c in range(R)]
                       for rr in range(R)] for l in range(levels)] for v in range(1 << g)]
            ref = _naive_multi_bit_step(ref, cs, ggsws, decomp)
        np.testing.assert_array_equal(to_numpy_u64(out[b]), np.array(ref, dtype=U64))


def test_multi_bit_wrapper_refuses_other_devices(rot):
    steps = LWE_DIM[rot["g"]] // rot["g"]
    acc = torch.zeros((1, R, N), dtype=torch.int64, device="meta")
    exps = torch.zeros((1, steps, (1 << rot["g"]) - 1), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        rotation.rotate_accumulator_multi_bit(acc, exps, rot["from_std"])


# ---------------------------------------------------------------------------
# (c) keygen
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g", [2, 3])
def test_multi_bit_keygen_encrypts_the_indicators(g):
    tp = TP[g]
    k, L, Bl = tp.glwe_dimension, tp.pbs_level, tp.pbs_base_log
    lwe_bits = rng.binary_key(rng.generator(7, 1, device="cpu"), (tp.lwe_dimension,))
    glwe_bits = rng.binary_key(rng.generator(7, 2, device="cpu"), (k, N))
    std = generate_multi_bit_bootstrap_key(
        rng.generator(7, 3, device="cpu"), interop.lwe_secret_key(lwe_bits, device="cpu"),
        interop.glwe_secret_key(glwe_bits, device="cpu"), tp.pbs_decomp, g, tp.glwe_noise_std)
    ng, nv = tp.lwe_dimension // g, 1 << g
    assert std.data.shape == (ng, nv, L, k + 1, k + 1, N) and std.grouping_factor == g
    ind = np_indicator_messages(lwe_bits.numpy(), g)
    np.testing.assert_array_equal(indicator_messages(lwe_bits, g).numpy(), ind)
    assert (ind.sum(axis=1) == 1).all()                  # one variant per group holds
    # every GGSW row (l, r) decrypts to -m*g_l*S_r (r < k) or m*g_l (r = k)
    data = to_numpy_u64(std.data).astype(object)
    gb = glwe_bits.numpy()
    mats = [_negacyclic_matrix(gb[c]).astype(np.int64).astype(object) for c in range(k)]
    for j in range(ng):
        for v in range(nv):
            m = int(ind[j, v])
            for l in range(L):
                g_l = 1 << (64 - Bl * (l + 1))
                for row in range(k + 1):
                    rows = data[j, v, l, row]
                    phase = rows[k] - sum(mats[c] @ rows[c] for c in range(k))
                    want = np.zeros(N, dtype=object)
                    if row < k:
                        want = -m * g_l * gb[row].astype(object)
                    else:
                        want[0] = m * g_l
                    err = (phase - want + 2 ** 63) % 2 ** 64 - 2 ** 63
                    assert max(abs(int(e)) for e in err) < 2 ** 40
    ntt_key = multi_bit_bootstrap_key_to_ntt(std, 4)
    assert ntt_key.spectra.shape == (ng, nv, 4, L * (k + 1), k + 1, N)
    flat = bootstrap_key_to_ntt(LweBootstrapKey(
        data=std.data.reshape((ng * nv,) + std.data.shape[2:]), decomp=tp.pbs_decomp), 4)
    assert torch.equal(ntt_key.spectra.reshape(flat.spectra.shape), flat.spectra)


# ---------------------------------------------------------------------------
# (d) shortint KS+PBS end to end, on the same numpy keys
# ---------------------------------------------------------------------------


@pytest.fixture
def pallas_interpret():
    """The JAX package's fused-kernel path in interpret mode; both switches
    restored afterwards."""
    old = (config.use_pallas_pbs(), config.pallas_interpret())
    config.set_use_pallas_pbs(True)
    config.set_pallas_interpret(True)
    yield
    config.set_use_pallas_pbs(old[0])
    config.set_pallas_interpret(old[1])


@jax.jit
def _jax_apply(sk, data, acc):
    ct = JCt(lwe=JLwe(data=data), degree=SPACE - 1, message_modulus=4, carry_modulus=4)
    return sk.apply_lookup_table(ct, JLut(acc=JGlwe(data=acc), degree=0)).lwe.data


def test_multi_bit_apply_lookup_table_matches_jax(pallas_interpret):
    g = 2
    tp, keys = TP[g], real_multi_bit_keys(TP[g], seed=33)
    jsk = JServerKey(ksk=JKsk(data=jnp.asarray(keys["ksk"]), decomp=JP.ks_decomp),
                     bsk=_jax_key(keys["bsk"], g), params=JPM[g])
    tsk = shortint.ServerKey(
        ksk=interop.keyswitch_key(keys["ksk"], tp.ks_decomp, device="cpu"),
        bsk=interop.multi_bit_bootstrap_key_from_standard(keys["bsk"], tp.pbs_decomp, g, 4,
                                                          device="cpu"),
        params=tp)
    f = lambda x: (3 * x + 1) % SPACE
    msgs = np.arange(SPACE)
    data = encrypt_big(tp, keys["big_bits"], msgs, seed=5)
    jlut = jsk.generate_lookup_table(f)
    ref = np.asarray(_jax_apply(jsk, jnp.asarray(data), jlut.acc.data))
    np.testing.assert_array_equal(decrypt_big(tp, keys["big_bits"], ref), f(msgs))

    before = rotation.multi_bit_launches
    ct = shortint.Ciphertext(lwe=LweCiphertext(data=from_numpy_u64(data)), degree=SPACE - 1)
    out = tsk.apply_lookup_table(ct, tsk.generate_lookup_table(f))
    np.testing.assert_array_equal(to_numpy_u64(out.lwe.data), ref)
    assert rotation.multi_bit_launches == before


def test_multi_bit_port_round_trip():
    """The port's own multi-bit keygen → encrypt → add, mul, greater → decrypt."""
    ck, sk = shortint.gen_keys(TP[3], seed=8, device="cpu")
    assert isinstance(sk.bsk, NttMultiBitBootstrapKey)
    a, b = torch.arange(SPACE) % 4, torch.arange(SPACE) // 4
    ca, cb = ck.encrypt(a, seed=1), ck.encrypt(b, seed=2)
    assert torch.equal(ck.decrypt(sk.add(ca, cb)), (a + b) % 4)
    assert torch.equal(ck.decrypt(sk.mul(ca, cb)), (a * b) % 4)
    assert torch.equal(ck.decrypt(sk.greater(ca, cb)), (a > b).long())


# ---------------------------------------------------------------------------
# the entry points run on the card unless asked for the CPU
# ---------------------------------------------------------------------------

_Z16 = np.zeros((2, 1, 2, 2, 16), dtype=U64)
ENTRY_POINTS = {
    "gen_keys": lambda: shortint.gen_keys(TP[2], seed=1)[0].lwe_sk.bits,
    "lwe_secret_key": lambda: interop.lwe_secret_key(np.zeros(4, np.int8)).bits,
    "glwe_secret_key": lambda: interop.glwe_secret_key(np.zeros((1, 16), np.int8)).bits,
    "keyswitch_key": lambda: interop.keyswitch_key(np.zeros((4, 1, 3), U64),
                                                   DecompParams(4, 1)).data,
    "bootstrap_key_from_standard": lambda: interop.bootstrap_key_from_standard(
        _Z16, DecompParams(7, 1), 2).spectra,
    "bootstrap_key_from_dif": lambda: interop.bootstrap_key_from_dif(
        np.zeros((2, 2, 2, 2, 16), U64), ntt.primes_for(16)[:2], DecompParams(7, 1)).spectra,
    "multi_bit_bootstrap_key_from_standard": lambda: (
        interop.multi_bit_bootstrap_key_from_standard(_Z16.reshape(1, 2, 1, 2, 2, 16),
                                                      DecompParams(7, 1), 1, 2).spectra),
    "multi_bit_bootstrap_key_from_dif": lambda: interop.multi_bit_bootstrap_key_from_dif(
        np.zeros((1, 4, 2, 2, 2, 16), U64), ntt.primes_for(16)[:2], DecompParams(7, 1),
        2).spectra,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_run_on_the_card_by_default(name):
    if torch.cuda.is_available():
        assert ENTRY_POINTS[name]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ENTRY_POINTS[name]()
