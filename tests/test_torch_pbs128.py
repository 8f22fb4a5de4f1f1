"""The port's 2^128 torus (`tfhe_tpu_torch/core/u128.py`,
`core/decomposition.py` `signed_decompose128`, the 128-bit ends of
`core/poly/ntt.py`, K8 and its plain version in
`core/poly/external_product.py`, `core/algorithms/pbs128.py`) bit for bit
against tfhe_tpu's (tolerance 0) at tests/test_pbs128.py's widths (n = 16,
k = 1, N = 256, PBS 12 x 1, KS 8 x 4):

* the two-limb ops against Python ints, with both limbs' top bits set;
* the decomposition at base_log * level < 64 and = 64;
* the forward transform, the Garner lift and the product;
* the external product, the blind rotation and the PBS on JAX's key
  carried across as standard words, and the keyswitch (its four-word K2′
  form and the plain 128-bit sum) on JAX's KSK;
* with noise 0, every key and ciphertext word the port makes equals JAX's
  under the same threefry key; with noise, the port's own keys decrypt
  and its noise has the asked-for spread (held statistically: it comes
  from a torch generator);
* K8's CUDA source built for the host (tests/cuda_host_stub.h) against
  its plain version.

The JAX side is jitted once a shape."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.core import rng as jrng
from tfhe_tpu.core import u128 as J
from tfhe_tpu.core.algorithms import generate_glwe_secret_key, generate_lwe_secret_key
from tfhe_tpu.core.algorithms import pbs128 as JM
from tfhe_tpu.core.decomposition import signed_decompose128 as jax_decompose128
from tfhe_tpu.core.params import DecompParams as JD
from tfhe_tpu.core.poly import get_plan as jax_plan
from tfhe_tpu.core.poly import ntt as JN
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core import threefry
from tfhe_tpu_torch.core import u128 as T
from tfhe_tpu_torch.core.algorithms import pbs128 as M
from tfhe_tpu_torch.core.decomposition import signed_decompose128
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.core.poly import external_product as ep
from tfhe_tpu_torch.core.poly import monomial_mul128, ntt
from tfhe_tpu_torch.core.poly.rotation import _delta_tables
from cuda_host import build_external_product_host

U64 = np.uint64
Q = 1 << 128
PBS, KS = (12, 1), (8, 4)
DELTA = 1 << 123                 # 4-bit messages and a padding bit


def words128(rng, shape, top=True) -> np.ndarray:
    """Uniform [*shape, 2] u64 limbs; the first elements with top bits set."""
    w = rng.integers(0, 2 ** 64, tuple(shape) + (2,), dtype=U64)
    if top:
        flat = w.reshape(-1, 2)
        flat[:4] = [[2 ** 64 - 1, 2 ** 64 - 1], [2 ** 63, 2 ** 63], [2 ** 63 - 1, 2 ** 63],
                    [0, 2 ** 64 - 1]]
    return w


def t128(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=U64)).view(np.int64).copy())


def same(t, j):
    np.testing.assert_array_equal(t.numpy().view(U64), np.asarray(j))


def test_u128_ops_equal_python_ints():
    rng = np.random.default_rng(1)
    a, b = words128(rng, (64,)), words128(rng, (64,), top=False)
    b[:2] = [[2 ** 63, 1], [2 ** 64 - 1, 0]]
    ta, tb = t128(a), t128(b)
    ai, bi = T.to_python_ints(ta), T.to_python_ints(tb)
    assert (T.to_python_ints(T.add128(ta, tb)) == (ai + bi) % Q).all()
    assert (T.to_python_ints(T.sub128(ta, tb)) == (ai - bi) % Q).all()
    assert (T.to_python_ints(T.neg128(ta)) == (-ai) % Q).all()
    assert T.to_python_ints(T.sum128(ta, dim=0)) == sum(ai) % Q
    assert (T.to_python_ints(T.sum128(ta.reshape(8, 8, 2), dim=-1))
            == (ai.reshape(8, 8).sum(axis=-1) % Q)).all()
    d = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, 64))
    want = np.array([(x * v) % Q for x, v in zip(d.tolist(), ai)], dtype=object)
    assert (T.to_python_ints(T.mul_small_signed_by_128(d, ta)) == want).all()
    t = torch.from_numpy(rng.integers(0, 1 << 32, 64))
    t[0] = (1 << 32) - 1
    c = (0xDEADBEEFCAFEBABE << 64) | 0xFEEDFACE01234567
    want = np.array([(x * c) % Q for x in t.tolist()], dtype=object)
    assert (T.to_python_ints(T.mul_u64_by_u128(t, c >> 64, c & (2 ** 64 - 1))) == want).all()
    assert (T.to_python_ints(T.from_python_ints(list(ai), "cpu")) == ai).all()
    assert T.to_python_ints(T.from_python_int(-3, (2,), "cpu")).tolist() == [Q - 3, Q - 3]
    # the same as the JAX package's on the same words
    same(T.add128(ta, tb), J.add128(jnp.asarray(a), jnp.asarray(b)))
    same(T.neg128(ta), J.neg128(jnp.asarray(a)))


@pytest.mark.parametrize("base_log, level", [(12, 3), (23, 1), (8, 8), (16, 4), (21, 3)])
def test_signed_decompose128_equals_jax(base_log, level):
    """Below 64 (12 x 3, 23 x 1, 21 x 3) and at 64 (8 x 8, 16 x 4, where
    lo's top bit rounds), on words with both top bits set."""
    x = words128(np.random.default_rng(2 + base_log), (256,))
    got = signed_decompose128(t128(x), DecompParams(base_log, level))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_decompose128(jnp.asarray(x),
                                                              JD(base_log, level))))


def test_signed_decompose128_refuses_above_64():
    with pytest.raises(ValueError, match="at most 64"):
        signed_decompose128(torch.zeros((1, 2), dtype=torch.int64), DecompParams(13, 5))


@pytest.mark.parametrize("P", [5, 6, 7])
def test_ntt128_ends_equal_jax(P):
    """ntt_forward128 (the port's order is JAX's DIF order) and
    garner_to_torus128 on random residues, and negacyclic_polymul128 against
    JAX and a Python-int model."""
    rng = np.random.default_rng(3)
    n = 64
    x = words128(rng, (3, n))
    jplan, plan = jax_plan(n, P), ntt.get_plan(n, P)
    same(ntt.ntt_forward128(plan, t128(x)), JN.ntt_forward128(jplan, jnp.asarray(x)))
    res = np.stack([rng.integers(0, p, (3, n)) for p in plan.primes], axis=-2)
    res[0, :, :4] = 0
    same(ntt.garner_to_torus128(plan, torch.from_numpy(res)),
         JN.garner_to_torus128(jplan, jnp.asarray(res.astype(U64))))
    b = rng.integers(-8, 9, n)
    got = ntt.negacyclic_polymul128(t128(x[0]), torch.from_numpy(b), 128 + 6 + 4)
    same(got, JN.negacyclic_polymul128(jnp.asarray(x[0]), jnp.asarray(b), 128 + 6 + 4))
    ai = T.to_python_ints(t128(x[0]))
    ref = [0] * n
    for i in range(n):
        s = int(ai[i]) - Q if ai[i] >= Q // 2 else int(ai[i])
        for j in range(n):
            ref[(i + j) % n] += s * int(b[j]) * (1 if i + j < n else -1)
    assert T.to_python_ints(got).tolist() == [v % Q for v in ref]


def _jax_k8(acc, key, exps, decomp):
    """JAX's external_product_accumulate128 on X^e acc - acc, rows [B]."""
    def one(a, e):
        diff = J.sub128(JM.monomial_mul128(a, e), a)
        return JM.external_product_accumulate128(a, diff, key, decomp)
    return jax.jit(jax.vmap(one))(jnp.asarray(acc), jnp.asarray(exps))


@pytest.mark.parametrize("base_log, level", [(12, 1), (16, 4)])
def test_k8_plain_equals_jax(base_log, level):
    """K8's plain version against JAX's external product at N = 256, k = 1,
    over the primes `external_product_num_primes128` gives, exponents with
    and without the wrap, top-bit words; and monomial_mul128 alone."""
    rng = np.random.default_rng(4 + level)
    n, R = 256, 2
    decomp = DecompParams(base_log, level)
    P = M.external_product_num_primes128(n, R, decomp)
    assert P == JM.external_product_num_primes128(n, R, JD(base_log, level))
    plan = ntt.get_plan(n, P)
    acc = words128(rng, (4, R, n))
    key = np.stack([rng.integers(0, p, (level * R, R, n)) for p in plan.primes])
    exps = np.array([0, 5, 300, 511])
    got = ep.external_product128_plain(t128(acc), torch.from_numpy(key).to(torch.int32),
                                       decomp, torch.from_numpy(exps))
    same(got, _jax_k8(acc, jnp.asarray(key.astype(U64)), exps, JD(base_log, level)))
    same(monomial_mul128(t128(acc), torch.from_numpy(exps).reshape(4, 1)),
         jax.vmap(JM.monomial_mul128)(jnp.asarray(acc), jnp.asarray(exps)))


# ---------------------------------------------------------------------------
# keys: JAX's, carried across
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_keys():
    torch.set_num_threads(1)
    root = jrng.key_from_seed(128)
    ks = jrng.split(root, 8)
    lwe_sk = generate_lwe_secret_key(ks[0], 16)
    glwe_sk = generate_glwe_secret_key(ks[1], 1, 256)
    pbs, ksd = JD(*PBS), JD(*KS)
    std = jax.jit(lambda k: JM.generate_bootstrap_key128(k, lwe_sk, glwe_sk, pbs, 2.0 ** 60))(
        ks[2])
    bsk = jax.jit(lambda d: JM.bootstrap_key128_to_ntt(d, pbs))(std)
    ksk = jax.jit(lambda k: JM.generate_keyswitch_key128(
        k, glwe_sk.as_lwe_secret_key(), lwe_sk, ksd, 2.0 ** 60))(ks[3])
    return dict(lwe=np.asarray(lwe_sk.bits), glwe=np.asarray(glwe_sk.bits),
                std=np.asarray(std), bsk=bsk, ksk=ksk, jlwe=lwe_sk, jglwe=glwe_sk)


@pytest.fixture(scope="module")
def port_keys(jax_keys):
    bsk = M.bootstrap_key128_to_ntt(t128(jax_keys["std"]), DecompParams(*PBS))
    ksk = M.KeyswitchKey128(data=t128(np.asarray(jax_keys["ksk"].data)),
                            decomp=DecompParams(*KS))
    return dict(bsk=bsk, ksk=ksk,
                lwe=interop.lwe_secret_key(jax_keys["lwe"], device="cpu"),
                glwe=interop.glwe_secret_key(jax_keys["glwe"], device="cpu"))


def msgs128(vals) -> np.ndarray:
    return np.array([[(v * DELTA) >> 64, (v * DELTA) & (2 ** 64 - 1)] for v in vals],
                    dtype=U64)


def round_msg(phase: torch.Tensor, mod: int) -> list:
    return [int((int(v) + DELTA // 2) // DELTA) % mod for v in T.to_python_ints(phase)]


def lwe_under(bits, vals, seed, std=2.0 ** 70) -> np.ndarray:
    """Encryptions [B, n+1, 2] of vals at DELTA, numpy-made."""
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, 2 ** 64, (len(vals), bits.size, 2), dtype=U64)
    dot = T.sum128(torch.where(torch.from_numpy(bits.astype(bool))[:, None], t128(mask), 0),
                   dim=-1)
    noise = T.from_python_ints([int(v) for v in np.round(rng.normal(0, std, len(vals)))],
                              "cpu")
    body = T.add128(T.add128(dot, t128(msgs128(vals))), noise)
    return np.concatenate([mask, body.numpy().view(U64)[:, None, :]], axis=1)


def test_bootstrap_key_spectra_equal_jax(jax_keys, port_keys, monkeypatch):
    """The port's spectra of JAX's standard BSK are JAX's NTT key's residues
    (its DIF order is the port's order), also with a chunk boundary inside
    n = 16."""
    same(port_keys["bsk"].spectra.to(torch.int64), jax_keys["bsk"].data)
    monkeypatch.setattr(M, "NTT_CHUNK", 5)
    same(M.bootstrap_key128_to_ntt(t128(jax_keys["std"]), DecompParams(*PBS)).spectra
         .to(torch.int64), jax_keys["bsk"].data)


def _lut(f, n=256, space=16):
    box = n // space
    vals = [(f(i // box) * DELTA) % Q for i in range(n)]
    vals = vals[box // 2:] + [(-x) % Q for x in vals[:box // 2]]
    return np.array([[x >> 64, x & (2 ** 64 - 1)] for x in vals], dtype=U64)


def test_pbs128_equals_jax(jax_keys, port_keys):
    """blind_rotate128 and programmable_bootstrap128 of 4 ciphertexts, a
    4-bit LUT: every word equal to JAX's, decrypted right."""
    f = lambda x: (3 * x + 1) % 16
    lut = np.concatenate([np.zeros((1, 256, 2), dtype=U64), _lut(f)[None]], axis=0)
    vals = [0, 3, 7, 15]
    ct = lwe_under(jax_keys["lwe"], vals, seed=5)
    got = M.programmable_bootstrap128(M.Lwe128(data=t128(ct)), M.Glwe128(data=t128(lut)),
                                      port_keys["bsk"])
    want = jax.jit(lambda c, l: JM.programmable_bootstrap128(JM.Lwe128(data=c),
                                                             JM.Glwe128(data=l),
                                                             jax_keys["bsk"]).data)(
        jnp.asarray(ct), jnp.asarray(lut))
    same(got.data, want)
    phase = M.decrypt_lwe128(got, port_keys["glwe"].as_lwe_secret_key())
    assert round_msg(phase, 16) == [f(v) for v in vals]


def test_keyswitch128_equals_jax(jax_keys, port_keys):
    """keyswitch128 (the four-word contraction) and keyswitch128_plain on
    JAX's KSK, equal to JAX's keyswitch128, decrypted right."""
    vals = [1, 7, 12, 15]
    ct = lwe_under(jax_keys["glwe"].reshape(-1), vals, seed=6, std=2.0 ** 60)
    want = jax.jit(lambda c: JM.keyswitch128(JM.Lwe128(data=c), jax_keys["ksk"]).data)(
        jnp.asarray(ct))
    got = M.keyswitch128(M.Lwe128(data=t128(ct)), port_keys["ksk"])
    same(got.data, want)
    same(M.keyswitch128_plain(M.Lwe128(data=t128(ct)), port_keys["ksk"]).data, want)
    assert round_msg(M.decrypt_lwe128(got, port_keys["lwe"]), 32) == vals


@pytest.mark.parametrize("base_log, level", [(5, 3), (16, 4), (8, 8)])
def test_keyswitch128_word_form_equals_plain_sum(base_log, level):
    """The word form against the plain 128-bit sum on a uniform key and
    top-bit inputs: the tensor-core form's shape (5 x 3), the wide form's
    (16 x 4) and b * L = 64 on the tensor-core form (8 x 8), where lo's top
    bit rounds."""
    rng = np.random.default_rng(7 + base_log)
    n_in, n_out = 48, 9
    ksk = M.KeyswitchKey128(data=t128(words128(rng, (n_in, level, n_out + 1))),
                            decomp=DecompParams(base_log, level))
    ct = M.Lwe128(data=t128(words128(rng, (5, n_in + 1))))
    assert torch.equal(M.keyswitch128(ct, ksk).data, M.keyswitch128_plain(ct, ksk).data)


def test_encryption_and_keys_equal_jax_without_noise(jax_keys, monkeypatch):
    """Noise 0: the port's LWE and GLWE encryptions, BSK and KSK under the
    same threefry keys are JAX's, word for word."""
    key, jkey = threefry.key_from_seed(9, "cpu"), jrng.key_from_seed(9)
    lwe = interop.lwe_secret_key(jax_keys["lwe"], device="cpu")
    glwe = interop.glwe_secret_key(jax_keys["glwe"], device="cpu")
    gen = torch.Generator()
    pts = msgs128([1, 2, 3])
    same(M.encrypt_lwe128(key, gen, lwe, t128(pts), 0.0).data,
         JM.encrypt_lwe128(jkey, jax_keys["jlwe"], jnp.asarray(pts), 0.0).data)
    polys = words128(np.random.default_rng(10), (2, 256))
    same(M.encrypt_glwe128(key, gen, glwe, t128(polys), 0.0).data,
         JM.encrypt_glwe128(jkey, jax_keys["jglwe"], jnp.asarray(polys), 0.0).data)
    pbs = DecompParams(*PBS)
    monkeypatch.setattr(M, "BSK_CHUNK", 5)     # a chunk boundary inside n = 16
    same(M.generate_bootstrap_key128(key, gen, lwe, glwe, pbs, 0.0),
         jax.jit(lambda k: JM.generate_bootstrap_key128(k, jax_keys["jlwe"], jax_keys["jglwe"],
                                                        JD(*PBS), 0.0))(jkey))
    same(M.generate_keyswitch_key128(key, gen, glwe.as_lwe_secret_key(), lwe,
                                     DecompParams(*KS), 0.0).data,
         JM.generate_keyswitch_key128(jkey, jax_keys["jglwe"].as_lwe_secret_key(),
                                      jax_keys["jlwe"], JD(*KS), 0.0).data)


def test_port_keys_decrypt_and_noise_spread():
    """The port alone: its own BSK and KSK (noise 2^60) carry a keyswitch
    then a PBS of 8 ciphertexts to the right LUT values; its gaussian has
    the asked-for spread (within 5% over 20,000 draws) and mean."""
    key = threefry.key_from_seed(11, "cpu")
    gen = torch.Generator()
    gen.manual_seed(11)
    rng = np.random.default_rng(11)
    lwe = interop.lwe_secret_key(rng.integers(0, 2, 16), device="cpu")
    glwe = interop.glwe_secret_key(rng.integers(0, 2, (1, 256)), device="cpu")
    big = glwe.as_lwe_secret_key()
    ks = threefry.split(key, 4)
    bsk = M.bootstrap_key128_to_ntt(M.generate_bootstrap_key128(
        ks[0], gen, lwe, glwe, DecompParams(*PBS), 2.0 ** 60), DecompParams(*PBS))
    ksk = M.generate_keyswitch_key128(ks[1], gen, big, lwe, DecompParams(*KS), 2.0 ** 60)
    vals = list(range(0, 16, 2))
    ct = M.encrypt_lwe128(ks[2], gen, big, t128(msgs128(vals)), 2.0 ** 70)
    g = lambda x: (5 * x + 3) % 16
    lut = M.trivial_glwe128(t128(_lut(g)), 1)
    out = M.programmable_bootstrap128(M.keyswitch128(ct, ksk), lut, bsk)
    assert round_msg(M.decrypt_lwe128(out, big), 16) == [g(v) for v in vals]
    noise = T.to_python_ints(T.gaussian_noise128(gen, (20000,), 2.0 ** 70))
    v = np.array([int(x) - Q if x >= Q // 2 else int(x) for x in noise], dtype=float) / 2 ** 70
    assert abs(v.std() - 1) < 0.05 and abs(v.mean()) < 0.05


# ---------------------------------------------------------------------------
# K8's CUDA source on the CPU, and its wrapper's refusals
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_external_product_host(tmp_path_factory.mktemp("host_k8"),
                                       ("tfhe_external_product128",))


# (base_log, level, P, the GGSW shared, rows, N, the form (cluster, stage): None the rule's)
K8_HOST_CASES = [(23, 1, 6, True, 2, 256, f) for f in ((1, False), (1, True), (2, False),
                                                      (2, True), (3, True), (6, False), None)] + [
    (16, 4, 7, False, 2, 256, (1, True)), (16, 4, 7, False, 2, 256, (7, False)),
    (16, 4, 7, False, 3, 64, None), (12, 3, 6, True, 2, 256, None),
    (12, 3, 6, True, 5, 32, (3, True)), (23, 1, 6, True, 1, 2048, None),
    (23, 1, 6, True, 1, 2048, (1, True)), (23, 1, 6, True, 3, 2048, (2, True))]


@pytest.mark.parametrize("base_log, level, P, shared, rows, n, form", K8_HOST_CASES)
def test_k8_host_build_equals_plain(host_lib, base_log, level, P, shared, rows, n, form):
    """K8 through its C entry at k = 1 against its plain version: 2_2's PBS
    decomposition on the 2^128 torus (23 x 1, P = 6) in every cluster that
    divides 6, staged and not, and at its N = 2048 (one warp a 256-slot
    region; in staged clusters of 2, the kernel compiled for that shape);
    b * L = 64 (16 x 4, P = 7, a GGSW a row; lo's top bit rounds) in one
    block a row (staged) and a cluster of 7; 12 x 3 in 3 rows at N = 32,
    clusters of 3; words with the top bit set in both limbs (C1), negative
    exponents and ones past 2N, with and without the wrap; out poisoned
    first."""
    R, decomp = 2, DecompParams(base_log, level)
    plan = ntt.get_plan(n, P)
    rng = np.random.default_rng(12 + level + n)
    acc = t128(words128(rng, (rows, R, n)))
    key = torch.stack([torch.from_numpy(rng.integers(0, p, (rows, level * R, R, n)))
                       for p in plan.primes], dim=1).to(torch.int32)   # [rows, P, J, R, N]
    exps = torch.tensor(([7, 2 * n - 3, -n, 1, 5 * n + 1] * rows)[:rows], dtype=torch.int64)
    k_in, ks = (key[0].contiguous(), 0) if shared else (key, key[0].numel())
    lay = ep._ep_layout(rows, n, R, level * R, P, form)
    out = torch.full((rows, R, n, 2), 12345, dtype=torch.int64)
    code = host_lib.tfhe_external_product128(
        acc.data_ptr(), R * n * 2, exps.data_ptr(), 1, k_in.data_ptr(), ks,
        _delta_tables(plan, "cpu", variants=True).data_ptr(), ep._ep_consts(plan).ctypes.data,
        out.data_ptr(), rows, plan.log_n, P, R, level, base_log, *ep._ep_launch_args(lay), None)
    assert code == 0
    want = ep.external_product128_plain(acc, k_in if shared else key, decomp,
                                        exps.to(torch.int64))
    assert torch.equal(out, want)
