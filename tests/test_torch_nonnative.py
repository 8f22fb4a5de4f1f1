"""The port's custom-modulus LWE (`tfhe_tpu_torch/core/algorithms/nonnative.py`)
bit for bit against tfhe_tpu's (tolerance 0) at the three moduli of
tests/test_nonnative.py (2^64 - 2^32 + 1, 2^48 - 59, 2^63): the masks
(threefry bits, two 64-bit draws reduced mod q), whole encryptions and the
seeded twins without noise, the linear algebra and the decomposition on
the same words, and with noise the round trip decrypted (the noise is the
port's own, from a torch generator).  Where q > 2^63 the JAX package's
sum wraps past 2^64 before it reduces (ROADMAP C13); the port compares
before it adds, a deliberate deviation.  So at 2^64 - 2^32 + 1 the sums
(the encryption's masked sum, add, plaintext add) are deviation tests:
the port equals a Python-int model, and JAX differs from the model
exactly where a sum wraps.  At the other moduli no sum reaches 2^64 and
they stay JAX parity cases.  The decomposition's rounding add goes through
`add_mod` too (C14); its JAX wrap changes no result, so the decomposition
stays a parity case at every modulus, beside a Python-int model."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.core import rng as jrng
from tfhe_tpu.core.algorithms import nonnative as J
from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.core.entities import LweSecretKey as JLweSk
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.core import threefry
from tfhe_tpu_torch.core.algorithms import nonnative as T
from tfhe_tpu_torch.core.entities import LweCiphertext

U64 = np.uint64
GOLDILOCKS_ISH = (1 << 64) - (1 << 32) + 1
Q_ODD_48 = (1 << 48) - 59
Q_POW2_63 = 1 << 63
ALL_Q = [GOLDILOCKS_ISH, Q_ODD_48, Q_POW2_63]


def t64(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=U64)).view(np.int64).copy())


def same(t, j):
    np.testing.assert_array_equal(t.numpy().view(U64), np.asarray(j))


def words(rng, shape, q):
    """Uniform words in [0, q), the largest values among them."""
    w = np.array([int(v) % q for v in rng.integers(0, 2 ** 64, int(np.prod(shape)),
                                                   dtype=U64)], dtype=object)
    w[:3] = [q - 1, q - 2, 0]
    return w.astype(U64).reshape(shape)


def ints(t) -> np.ndarray:
    return t.numpy().view(U64).astype(object)


def wrapping_body(mask, bits, pts, q):
    """The JAX package's body as Python ints: the scan of its add_mod, each
    a + b taken mod 2^64 before the compare with q; → (bodies, whether
    some sum of the row wrapped)."""
    bodies, wrapped = [], []
    for row, pt in zip(mask, pts):
        acc, w = 0, False
        for a in list(row[bits != 0]) + [int(pt)]:
            s = acc + int(a)
            w |= s >= 1 << 64
            s %= 1 << 64
            acc = s - q if s >= q else s
        bodies.append(acc)
        wrapped.append(w)
    return bodies, wrapped


def keys(n, seed):
    bits = np.random.default_rng(seed).integers(0, 2, n).astype(np.int8)
    return interop.lwe_secret_key(bits, device="cpu"), JLweSk(bits=jnp.asarray(bits))


@pytest.mark.parametrize("q", ALL_Q)
def test_uniform_mod_equals_jax(q):
    got = T.uniform_mod(threefry.key_from_seed(3, "cpu"), (5, 7), q)
    same(got, J.uniform_mod(jrng.key_from_seed(3), (5, 7), q))
    assert all(v < q for v in got.numpy().view(U64).astype(object).ravel())


@pytest.mark.parametrize("q", ALL_Q)
def test_encryption_and_seeded_twins_equal_jax_without_noise(q):
    """Noise 0: the ciphertexts, the seeded bodies and their decompression
    word for word; decompressing the seeded form gives the direct form.  At
    q > 2^63 the bodies are a deviation test (C13): the masks equal JAX's,
    the bodies a Python-int model."""
    tsk, jsk = keys(64, 4)
    pts = np.array([123456789, 5, q - 1, 0], dtype=U64)
    key, jkey = threefry.key_from_seed(5, "cpu"), jrng.key_from_seed(5)
    gen = torch.Generator()
    ct = T.encrypt_lwe_custom_mod(key, gen, tsk, t64(pts), 0.0, q)
    jct = J.encrypt_lwe_custom_mod(jkey, jsk, jnp.asarray(pts), 0.0, q).data
    bodies = T.encrypt_seeded_lwe_custom_mod(key, gen, tsk, t64(pts), 0.0, q)
    jbodies = J.encrypt_seeded_lwe_custom_mod(jkey, jsk, jnp.asarray(pts), 0.0, q)
    if q > 1 << 63:
        # C13: the port's body is sum a_i s_i + pt mod q; JAX's differs
        # exactly in the rows where one of its sums wrapped past 2^64
        same(ct.mask, np.asarray(jct)[:, :-1])
        mask, bits = ints(ct.mask), tsk.bits.numpy()
        model = [(sum(int(a) for a in row[bits != 0]) + int(pt)) % q
                 for row, pt in zip(mask, pts)]
        jax_model, wrapped = wrapping_body(mask, bits, pts, q)
        assert list(ints(ct.body)) == model and list(ints(bodies)) == model
        assert list(np.asarray(jbodies).astype(object)) == jax_model
        assert [j != m for j, m in zip(jax_model, model)] == wrapped and any(wrapped)
    else:
        same(ct.data, jct)
        same(bodies, jbodies)
    back = T.decompress_seeded_lwe_custom_mod(key, bodies, 64, q)
    assert torch.equal(back.data, ct.data)
    same(back.data, J.decompress_seeded_lwe_custom_mod(jkey, jnp.asarray(bodies.numpy()
                                                                         .view(U64)), 64,
                                                       q).data)
    phase = T.decrypt_lwe_custom_mod(ct, tsk, q)
    if q > 1 << 63:
        # without noise the port's phase is the plaintext (JAX's dot wraps)
        same(phase, pts)
    else:
        same(phase, J.decrypt_lwe_custom_mod(JLwe(data=jnp.asarray(ct.data.numpy().view(U64))),
                                             jsk, q))


@pytest.mark.parametrize("q", ALL_Q)
def test_encrypt_decrypt_with_noise(q):
    """The port's noise (rel. std 2^-25): 32 messages of 16 decrypt right;
    the mask is still JAX's."""
    tsk, jsk = keys(64, 6)
    p, delta = 16, q // 32
    msgs = np.arange(32) % p
    pts = [int(m) * delta for m in msgs]
    gen = torch.Generator()
    gen.manual_seed(6)
    ct = T.encrypt_lwe_custom_mod(threefry.key_from_seed(7, "cpu"), gen, tsk, pts, 2.0 ** -25, q)
    jct = J.encrypt_lwe_custom_mod(jrng.key_from_seed(7), jsk, jnp.asarray(pts, dtype=U64),
                                   2.0 ** -25, q)
    same(ct.mask, jct.mask)
    phase = T.decrypt_lwe_custom_mod(ct, tsk, q).numpy().view(U64).astype(object)
    assert [((v + delta // 2) % q) // delta % p for v in phase] == msgs.tolist()


@pytest.mark.parametrize("q", ALL_Q)
def test_linear_algebra_equals_jax(q):
    """add, sub, neg, plaintext add and cleartext mul on the same words;
    at q > 2^63 the two sums are deviation tests (C13)."""
    rng = np.random.default_rng(8)
    a, b = words(rng, (6, 17), q), words(rng, (6, 17), q)
    ta, tb = LweCiphertext(data=t64(a)), LweCiphertext(data=t64(b))
    ja, jb = JLwe(data=jnp.asarray(a)), JLwe(data=jnp.asarray(b))
    pt = words(rng, (6,), q)
    sums = [(T.lwe_add_custom_mod(ta, tb, q).data, J.lwe_add_custom_mod(ja, jb, q).data,
             a.astype(object), b.astype(object)),
            (T.lwe_plaintext_add_custom_mod(ta, t64(pt), q).data[:, -1],
             np.asarray(J.lwe_plaintext_add_custom_mod(ja, jnp.asarray(pt), q).data)[:, -1],
             a[:, -1].astype(object), pt.astype(object))]
    for got, jax_got, x, y in sums:
        if q > 1 << 63:
            # C13: the port is (x + y) mod q; JAX differs exactly where
            # x + y wraps past 2^64 (by 2^64 - q each time)
            assert (ints(got) == (x + y) % q).all()
            wraps = x + y >= 1 << 64
            assert ((np.asarray(jax_got).astype(object) != (x + y) % q) == wraps).all()
            assert wraps.any()
        else:
            same(got, jax_got)
    same(T.lwe_sub_custom_mod(ta, tb, q).data, J.lwe_sub_custom_mod(ja, jb, q).data)
    same(T.lwe_neg_custom_mod(ta, q).data, J.lwe_neg_custom_mod(ja, q).data)
    for c in (3, q - 1, 1 << 40):
        same(T.lwe_cleartext_mul_custom_mod(ta, c, q).data,
             J.lwe_cleartext_mul_custom_mod(ja, c, q).data)


@pytest.mark.parametrize("q", ALL_Q)
def test_add_mod_equals_python_ints(q):
    """add_mod against (a + b) mod q in Python ints on every pair of the
    words q - 1, q - 2, q/2, 1, 0 and random words below q (C13: at q >
    2^63 most of the large pairs pass 2^64)."""
    edge = np.array([q - 1, q - 2, q // 2, 1, 0], dtype=object).astype(U64)
    w = np.concatenate([edge, words(np.random.default_rng(q % 1000), (59,), q)])
    a, b = np.repeat(w, len(w)), np.tile(w, len(w))
    got = ints(T.add_mod(t64(a), t64(b), q))
    assert (got == (a.astype(object) + b.astype(object)) % q).all()


def test_closest_representable_reference_vector():
    """decomposer.rs:338-340's doc test: q = 2^64 - 2^32 + 1, B = 2^4, l = 3."""
    got = T.closest_representable_custom_mod(t64([16982820785129133100]), 4, 3, GOLDILOCKS_ISH)
    assert int(got.numpy().view(U64)[0]) == 16983074190859960320


@pytest.mark.parametrize("q", ALL_Q)
@pytest.mark.parametrize("base_log, level", [(4, 3), (1, 8), (7, 5)])
def test_decomposition_equals_jax(q, base_log, level):
    """closest_representable, the balanced terms and the recomposition
    summands on the same words."""
    x = words(np.random.default_rng(9 + level), (64,), q)
    tx, jx = t64(x), jnp.asarray(x)
    same(T.closest_representable_custom_mod(tx, base_log, level, q),
         J.closest_representable_custom_mod(jx, base_log, level, q))
    terms = T.decompose_custom_mod(tx, base_log, level, q)
    jterms = J.decompose_custom_mod(jx, base_log, level, q)
    same(terms, jterms)
    same(T.recomposition_summands_custom_mod(terms, base_log, level, q),
         J.recomposition_summands_custom_mod(jterms, base_log, level, q))


def rounded_model(x: int, sr: int, q: int) -> int:
    """The JAX function's rounding, ((x + sr/2) mod q) / sr, in Python ints."""
    return ((x + (sr >> 1)) % q) // sr


def terms_model(x: int, base_log: int, level: int, q: int) -> list:
    """The balanced terms of decompose_custom_mod in Python ints."""
    state, terms = rounded_model(x, q >> (base_log * level), q), []
    for _ in range(level):
        res = state & ((1 << base_log) - 1)
        state >>= base_log
        carry = (((res - 1) | state) & res) >> (base_log - 1)
        state += carry
        terms.append((res + q - (carry << base_log)) % q)
    return terms


def rounding_words(q: int, sr: int, rng) -> np.ndarray:
    """q - 1, q - 2, 2^64 - sr/2 and its neighbours where below q, then
    random words below q."""
    edge = [w for w in (q - 1, q - 2, (1 << 64) - (sr >> 1), (1 << 64) - (sr >> 1) + 1,
                        (1 << 64) - (sr >> 1) - 1) if 0 <= w < q]
    return np.concatenate([np.array(edge, dtype=object).astype(U64), words(rng, (61,), q)])


@pytest.mark.parametrize("q", ALL_Q)
@pytest.mark.parametrize("base_log, level", [(4, 3), (1, 8), (7, 5)])
def test_rounding_and_decomposition_equal_python_ints(q, base_log, level):
    """C14: closest_representable and the balanced terms against the JAX
    function's formula in Python ints, on the words below q nearest to q
    and to 2^64 - sr/2 and on random words."""
    sr = q >> (base_log * level)
    x = rounding_words(q, sr, np.random.default_rng(base_log * 100 + level))
    xs = [int(v) for v in x]
    got = ints(T.closest_representable_custom_mod(t64(x), base_log, level, q))
    assert list(got) == [rounded_model(v, sr, q) * sr % (1 << 64) for v in xs]
    terms = ints(T.decompose_custom_mod(t64(x), base_log, level, q))
    assert [list(row) for row in terms] == [terms_model(v, base_log, level, q) for v in xs]


@pytest.mark.parametrize("base_log, level", [(4, 3), (1, 8), (2, 4)])
def test_the_rounding_wrap_changes_no_result(base_log, level):
    """C14 at q = 2^64 - 2^32 + 1: on the words in [2^64 - sr/2, q) the JAX
    function's rounding add passes 2^64 and the port's does not.  Both
    land in [0, sr/2) (x + sr/2 - 2^64 and x + sr/2 - q), so both round
    to 0: JAX equals the port and the Python-int model on those words
    too."""
    q = GOLDILOCKS_ISH
    sr = q >> (base_log * level)
    rng = np.random.default_rng(base_log + level)
    low = (1 << 64) - (sr >> 1)
    wrap = [q - 1, q - 2, low] + [low + int(v) % (q - low) for v in
                                  rng.integers(0, 2 ** 63, 13, dtype=np.int64)]
    assert all(low <= v < q for v in wrap)
    x = np.array(wrap, dtype=object).astype(U64)
    tx, jx = t64(x), jnp.asarray(x)
    port = T.closest_representable_custom_mod(tx, base_log, level, q)
    same(port, J.closest_representable_custom_mod(jx, base_log, level, q))
    assert (ints(port) == 0).all() and all(rounded_model(v, sr, q) == 0 for v in wrap)
    terms = T.decompose_custom_mod(tx, base_log, level, q)
    same(terms, J.decompose_custom_mod(jx, base_log, level, q))
    assert [list(row) for row in ints(terms)] == [terms_model(v, base_log, level, q)
                                                  for v in wrap]


def test_bad_modulus_refused():
    with pytest.raises(ValueError, match="custom modulus"):
        T.decompose_custom_mod(t64([1]), 4, 3, 1 << 64)
