"""The gadget fork (`tfhe_tpu_torch.gadget`) against `tfhe_tpu.gadget`.

Bit for bit (tolerance 0) on the same numpy keys and ciphertexts, at
TEST_PARAMS_GADGET (KS → PBS) and its PBS → KS twin (`torch_gadget_jax`):
every `Encoding` method, `_round_torus_to_zp` and Δ (phases with the top
bit set, hazard C1), the accumulators, `Gadget.exec` (the four 2-input
gates and the 3-input majority), `apply_lut`, encoding switching and
`linear_combination`, `mvb`, simple and full tree bootstrapping (KS → PBS
only: the tree asserts it), `lwe_mult` and `woppbs_lut` (KS → PBS: their
packing key takes the big key's ciphertexts), `trivial_encrypt`,
`measure_noise` on the same ciphertext, and the dump records read both
ways.  The JAX PBS runs its fused route in interpret mode (the form K1
computes); MVB's common factor its XLA rotate-subtract `blind_rotate`
(the form `blind_rotate_only`, K7, computes; hazard C4).

Then the port alone: `gen_keys` → encrypt → gadget → decrypt against the
clear model in both orders, a random gate chain, fresh noise held
statistically (C5), and the entry points' default device (the card)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu.gadget as JG
import tfhe_tpu.gadget.engine as JE
from tfhe_tpu_torch import gadget as TG
from tfhe_tpu_torch.core.numeric import from_numpy_u64, to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_GADGET as P
from tfhe_tpu_torch.gadget import engine as TE
from torch_gadget_jax import (ORDERS, both, encodings, encrypt, interpreted_engine, jax_keys,
                              jw, numpy_gadget_keys, port_keys, tw)

U64 = np.uint64
SEED = 23
TOP = [0, 2 ** 63, 2 ** 64 - 1, 2 ** 63 - 1, 2 ** 63 + 1]
GATES = {"and": (lambda a, b: a & b, 2, [1, 2], 5),
         "or": (lambda a, b: a | b, 2, [1, 2], 5),
         "xor": (lambda a, b: a ^ b, 2, [1, 2], 5),
         "nand": (lambda a, b: 1 - (a & b), 2, [1, 2], 5),
         "maj3": (lambda a, b, c: int(a + b + c >= 2), 3, [1, 1, 1], 7)}


@pytest.fixture(scope="module", autouse=True)
def _engine():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with interpreted_engine():
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def keys():
    return numpy_gadget_keys(SEED)


def same(jct, tct, what=""):
    np.testing.assert_array_equal(jw(jct), tw(tct), err_msg=what)
    if hasattr(jct, "encoding"):
        assert (jct.encoding.origin_modulus, jct.encoding.modulus_p, jct.encoding.parts) == (
            tct.encoding.origin_modulus, tct.encoding.modulus_p, tct.encoding.parts), what


def decrypted(tck, tct):
    return TG.decrypt(tck, tct).numpy()


# ---------------------------------------------------------------------------
# host-side pieces: encodings, rounding, accumulators
# ---------------------------------------------------------------------------

ENCODINGS = [((2, [[0], [1]], 5), {}), ((5, [[0], [1], [2], [3], [4]], 11), {}),
             ((2, [[0, 4], [1, 2, 3]], 5), {}), ((2, [[0, 2], [1, 3]], 4), {}),
             ((16, [[i] for i in range(16)], 16), {"wopbs": True}),
             ((8, [[1]] * 8, 8), {"wopbs": True}), ((2, [[0], [1]], 2), {}),
             ((3, [[0], [1], [2]], 7), {})]


@pytest.mark.parametrize("args, kw", ENCODINGS)
def test_encoding_methods(args, kw):
    j, t = encodings(*args, **kw)
    p, o = j.modulus_p, j.origin_modulus
    assert (t.origin_modulus, t.modulus_p, t.parts, t.wopbs) == (o, p, j.parts, j.wopbs)
    assert t.is_valid() == j.is_valid() and t.is_canonical() == j.is_canonical()
    assert (t.get_modulus(), t.get_origin_modulus()) == (j.get_modulus(), j.get_origin_modulus())
    assert hash(t) == hash(j) and repr(t) == repr(j) and t == t and t != j
    for i in range(o):
        assert t.get_part(i) == j.get_part(i)
        assert t.negative_on_o_ring(i) == j.negative_on_o_ring(i)
        if j.is_canonical():
            assert t.get_part_single_value_if_canonical(i) == \
                j.get_part_single_value_if_canonical(i)
        for x in range(p):
            assert t.is_partition_containing(i, x) == j.is_partition_containing(i, x)
    for x in range(p):
        assert t.inverse_encoding(x) == j.inverse_encoding(x)
        assert t.negative_on_p_ring(x) == j.negative_on_p_ring(x)
    for f in (lambda x: x, lambda x: (x + 1) % o, lambda x: 0):
        a, b = t.apply_lut_to_encoding(f), j.apply_lut_to_encoding(f)
        assert (a.parts, a.modulus_p, a.wopbs) == (b.parts, b.modulus_p, b.wopbs)
    for c in (1, 2, 3):
        for name in ("multiply_encoding_by_constant", "add_constant"):
            try:
                want = getattr(j, name)(c)
            except ValueError:
                with pytest.raises(ValueError):
                    getattr(t, name)(c)
                continue
            got = getattr(t, name)(c)
            assert (got.parts, got.modulus_p) == (want.parts, want.modulus_p)


def test_encoding_constructors_and_refusal():
    for name, args in (("new_canonical", (3, [0, 2, 4], 7)), ("new_canonical_binary", (3, 7)),
                       ("parity_encoding", ()), ("new_trivial", (5,)),
                       ("new_trivial_wopbs", (16,)), ("new_all_one_wopbs", (8,))):
        j = getattr(JG.Encoding, name)(*args)
        t = getattr(TG.Encoding, name)(*args)
        assert (t.origin_modulus, t.modulus_p, t.parts, t.wopbs) == (
            j.origin_modulus, j.modulus_p, j.parts, j.wopbs), name
    for enc in (JG.Encoding, TG.Encoding):
        with pytest.raises(ValueError):
            enc(2, [[0], [2]], 4)      # even p, not negacyclic


@pytest.mark.parametrize("p", [2, 3, 5, 7, 11, 16, 17, 1021, 2 ** 31 - 1])
def test_round_torus_to_zp_and_delta(p):
    rng = np.random.default_rng(p)
    phases = rng.integers(0, 2 ** 64, 64, dtype=U64)
    phases[:len(TOP)] = TOP
    slots = np.arange(min(p, 16), dtype=object)
    edges = [(int(k) * (1 << 64) // p + d) % (1 << 64) for k in slots for d in (-1, 0, 1)]
    phases = np.concatenate([phases, np.array(edges, dtype=U64)])
    want = np.asarray(jax.jit(JE._round_torus_to_zp, static_argnums=1)(jnp.asarray(phases), p))
    got = TE._round_torus_to_zp(from_numpy_u64(phases), p).numpy()
    np.testing.assert_array_equal(got, want)
    assert TE.delta_for_modulus(p) == int(JE.delta_for_modulus(p))


IDENT16 = [[i] for i in range(16)]
ACCUMULATORS = [
    (None, None),                                # the AND gadget's sum into its output
    (((5, [[0], [1], [2], [3], [4]], 11), {}), ((5, [[0], [2], [4], [6], [8]], 11), {})),
    (((2, [[0], [1]], 2), {}), ((2, [[3], [1]], 4), {"wopbs": True})),   # p = 2: two halves
    (((2, [[1], [0]], 2), {}), ((2, [[3], [1]], 4), {"wopbs": True})),
    (((16, IDENT16, 16), {"wopbs": True}), ((16, IDENT16, 16), {"wopbs": True})),  # even p
    (((16, IDENT16, 17), {}), ((16, [[1]] * 16, 16), {"wopbs": True})),
]


@pytest.mark.parametrize("enc_in, enc_out", ACCUMULATORS)
def test_accumulators(enc_in, enc_out):
    if enc_in is None:
        jg = JE.Gadget.new_canonical(*_gate_args("and"))
        tg = TE.Gadget.new_canonical(*_gate_args("and"))
        ji, jo, ti, to = jg.enc_inter, jg.enc_out, tg.enc_inter, tg.enc_out
    else:
        ji, ti = encodings(*enc_in[0], **enc_in[1])
        jo, to = encodings(*enc_out[0], **enc_out[1])
    want = np.asarray(JE.build_accumulator_glwe(P, ji, jo).data)
    got = to_numpy_u64(TE.build_accumulator_glwe(P, ti, to, "cpu").data)
    np.testing.assert_array_equal(got, want)
    want = np.asarray(JE.build_common_factor_accumulator(P, jo).data)
    got = to_numpy_u64(TE.build_common_factor_accumulator(P, to, "cpu").data)
    np.testing.assert_array_equal(got, want)
    if ji.modulus_p % 2 == 1:
        np.testing.assert_array_equal(TE._create_vi_for_mvb(P, ti, to),
                                      JE._create_vi_for_mvb(P, ji, jo))


def _gate_args(name):
    fn, arity, vals, p = GATES[name]
    return fn, arity, vals, 1, p, p


# ---------------------------------------------------------------------------
# the engine, both packages on the same words
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("gate", list(GATES))
def test_gadget_exec(keys, order, gate):
    jck, jsk = jax_keys(keys, order)
    tck, tsk = port_keys(keys, order)
    jg = JE.Gadget.new_canonical(*_gate_args(gate))
    tg = TE.Gadget.new_canonical(*_gate_args(gate))
    arity = GATES[gate][1]
    combos = list(itertools.product([0, 1], repeat=arity))
    cols = list(zip(*combos))
    pairs = [both(encrypt(keys, order, col, jg.enc_in[i], seed=40 + i), jg.enc_in[i])
             for i, col in enumerate(cols)]
    jout = jg.exec(jsk, [j for j, _ in pairs])
    tout = tg.exec(tsk, [t for _, t in pairs])
    same(jout, tout, f"{gate} {order}")
    np.testing.assert_array_equal(decrypted(tck, tout), [tg.exec_clear(c) for c in combos])


@pytest.mark.parametrize("order", list(ORDERS))
def test_lut_switching_and_linear(keys, order):
    jck, jsk = jax_keys(keys, order)
    tck, tsk = port_keys(keys, order)
    jenc, tenc = encodings(5, [[0], [1], [2], [3], [4]], 11)
    msgs = [0, 1, 2, 3, 4]
    jct, tct = both(encrypt(keys, order, msgs, jenc, seed=50), jenc)
    f = lambda x: (x * 2) % 5
    out = TE.apply_lut(tsk, tct, tenc, f)
    same(JE.apply_lut(jsk, jct, jenc, f), out, "apply_lut")
    np.testing.assert_array_equal(decrypted(tck, out), [f(m) for m in msgs])

    j5, t5 = encodings(2, [[0], [1]], 5)
    j7, t7 = encodings(2, [[0], [1]], 7)
    bits = [0, 1, 1]
    jb, tb = both(encrypt(keys, order, bits, j5, seed=51), j5)
    out = TE.encoding_switching_lut(tsk, tb, t7)
    same(JE.encoding_switching_lut(jsk, jb, j7), out, "encoding_switching_lut")
    np.testing.assert_array_equal(decrypted(tck, out), bits)
    (jsw,), (tsw,) = JE.Gadget.modulus_switching(jsk, [jb], [5], 7), \
        TE.Gadget.modulus_switching(tsk, [tb], [5], 7)
    same(jsw, tsw, "modulus_switching")

    jm, tm = JE.encoding_switching_mul_constant(jb, 3), TE.encoding_switching_mul_constant(tb, 3)
    same(jm, tm, "encoding_switching_mul_constant")
    ja, ta = JE.encoding_switching_sum_constant(jb, 2), TE.encoding_switching_sum_constant(tb, 2)
    same(ja, ta, "encoding_switching_sum_constant")
    for ct in (tm, ta):
        np.testing.assert_array_equal(decrypted(tck, ct), bits)

    j7c, t7c = encodings(7, [[i] for i in range(7)], 7)
    xs, ys = [1, 2, 3], [2, 0, 6]
    jx, tx = both(encrypt(keys, order, xs, j7c, seed=52), j7c)
    jy, ty = both(encrypt(keys, order, ys, j7c, seed=53), j7c)
    out = TE.linear_combination([tx, ty], [2, 3], 7)
    same(JE.linear_combination([jx, jy], [2, 3], 7), out, "linear_combination")
    np.testing.assert_array_equal(decrypted(tck, out), (2 * np.array(xs) + 3 * np.array(ys)) % 7)
    same(JE.simple_mul_constant(jx, 10, 7), TE.simple_mul_constant(tx, 10, 7), "mul_constant")
    same(JE.simple_plaintext_sum(jx, 4, 7), TE.simple_plaintext_sum(tx, 4, 7), "plaintext_sum")
    same(JE.simple_sum([jx, jy]), TE.simple_sum([tx, ty]), "simple_sum")
    np.testing.assert_array_equal(decrypted(tck, TE.simple_plaintext_sum(tx, 4, 7)),
                                  (np.array(xs) + 4) % 7)


@pytest.mark.parametrize("order", list(ORDERS))
def test_mvb(keys, order):
    jck, jsk = jax_keys(keys, order)
    tck, tsk = port_keys(keys, order)
    jenc, tenc = encodings(5, [[0], [1], [2], [3], [4]], 11)
    luts = [[(2 * x) % 5 for x in range(5)], [(x + 1) % 5 for x in range(5)]]
    msgs = [0, 1, 2, 3, 4]
    jct, tct = both(encrypt(keys, order, msgs, jenc, seed=60), jenc)
    jouts = JE.mvb(jsk, jct, [jenc, jenc], luts)
    touts = TE.mvb(tsk, tct, [tenc, tenc], luts)
    for lut, jo, to in zip(luts, jouts, touts):
        same(jo, to, f"mvb {order}")
        np.testing.assert_array_equal(decrypted(tck, to), [lut[m] for m in msgs])


def test_tree_bootstrapping(keys):
    jck, jsk = jax_keys(keys, "ks_pbs")
    tck, tsk = port_keys(keys, "ks_pbs")
    o, t = 3, 9
    jenc, tenc = encodings(o, [[0], [1], [2]], 7)
    x0, x1 = [0, 1, 2, 2], [0, 2, 1, 2]
    j0, t0 = both(encrypt(keys, "ks_pbs", x0, jenc, seed=70), jenc)
    j1, t1 = both(encrypt(keys, "ks_pbs", x1, jenc, seed=71), jenc)
    lut = [(2 * i + 1) % o for i in range(t)]
    out = TE.simple_tree_bootstrapping(tsk, [t1, t0], tenc, t, lut)
    same(JE.simple_tree_bootstrapping(jsk, [j1, j0], jenc, t, lut), out, "simple tree")
    np.testing.assert_array_equal(decrypted(tck, out), [lut[a + o * b] for a, b in zip(x0, x1)])
    f = lambda x: (x * 2 + 1) % t
    jhi, jlo = JE.full_tree_bootstrapping(jsk, [j1, j0], [jenc, jenc], t, f)
    thi, tlo = TE.full_tree_bootstrapping(tsk, [t1, t0], [tenc, tenc], t, f)
    same(jhi, thi, "full tree, high digit")
    same(jlo, tlo, "full tree, low digit")
    vals = [f(a + o * b) for a, b in zip(x0, x1)]
    np.testing.assert_array_equal(decrypted(tck, tlo), [v % o for v in vals])
    np.testing.assert_array_equal(decrypted(tck, thi), [v // o for v in vals])
    # the tree asserts KS -> PBS, as the JAX function does
    _, tsk_small = port_keys(keys, "pbs_ks")
    with pytest.raises(AssertionError):
        TE.simple_tree_bootstrapping(tsk_small, [t1, t0], tenc, t, lut)


def test_lwe_mult_and_woppbs(keys):
    jck, jsk = jax_keys(keys, "ks_pbs")
    tck, tsk = port_keys(keys, "ks_pbs")
    jw16, tw16 = encodings(16, [[i] for i in range(16)], 16, wopbs=True)
    a, b = [0, 1, 2, 3], [0, 3, 5, 5]
    ja, ta = both(encrypt(keys, "ks_pbs", a, jw16, seed=80), jw16)
    jb, tb = both(encrypt(keys, "ks_pbs", b, jw16, seed=81), jw16)
    out = TE.lwe_mult(tsk, ta, tb, tw16)
    same(JE.lwe_mult(jsk, ja, jb, jw16), out, "lwe_mult")
    np.testing.assert_array_equal(decrypted(tck, out), (np.array(a) * np.array(b)) % 16)
    jin, tin = encodings(16, [[i] for i in range(16)], 17)
    msgs = [0, 1, 7, 12, 15]
    jct, tct = both(encrypt(keys, "ks_pbs", msgs, jin, seed=82), jin)
    f = lambda x: (3 * x + 1) % 16
    out = TE.woppbs_lut(tsk, tct, tw16, f)
    same(JE.woppbs_lut(jsk, jct, jw16, f), out, "woppbs_lut")
    np.testing.assert_array_equal(decrypted(tck, out), [f(m) for m in msgs])
    with pytest.raises(AssertionError):            # odd log_p, as the reference asserts
        j8, t8 = encodings(8, [[i] for i in range(8)], 8, wopbs=True)
        TE.lwe_mult(tsk, TE.Ciphertext(lwe=ta.lwe, encoding=t8),
                    TE.Ciphertext(lwe=tb.lwe, encoding=t8), t8)


@pytest.mark.parametrize("order", list(ORDERS))
def test_trivial_encrypt_decrypt_and_noise(keys, order):
    jck, _ = jax_keys(keys, order)
    tck, _ = port_keys(keys, order)
    jenc, tenc = encodings(5, [[0], [1], [2], [3], [4]], 11)
    params = ORDERS[order]
    jtr = JE.trivial_encrypt(params[1], jnp.arange(5), jenc)
    ttr = TE.trivial_encrypt(params[0], torch.arange(5), tenc, device="cpu")
    same(jtr, ttr, "trivial_encrypt")
    np.testing.assert_array_equal(decrypted(tck, ttr), np.arange(5))
    data = encrypt(keys, order, [0, 1, 2, 3, 4], jenc, seed=90)
    data[0, -1] ^= U64(1 << 63)                 # a phase with the top bit flipped
    jct, tct = both(data, jenc)
    np.testing.assert_array_equal(TG.measure_noise(tck, tct), JG.measure_noise(jck, jct))
    np.testing.assert_array_equal(TG.measure_noise(tck, ttr), JG.measure_noise(jck, jtr))
    jrest, trest = both(data[1:], jenc)
    np.testing.assert_array_equal(decrypted(tck, trest), JG.decrypt(jck, jrest))
    bad = TE.Ciphertext(lwe=tct.lwe, encoding=TE.Encoding(2, [[0], [1]], 11))
    with pytest.raises(ValueError, match="No value in Zo"):
        TG.decrypt(tck, bad)


def test_dumps_read_both_ways(keys, tmp_path, monkeypatch):
    jenc, tenc = encodings(2, [[0], [1]], 5)
    jct, tct = both(encrypt(keys, "ks_pbs", [1, 0], jenc, seed=91), jenc)
    trec = TG.SerializableCiphertext.from_ciphertext(tct, expected_msg=1)
    jrec = JG.SerializableCiphertext.from_ciphertext(jct, expected_msg=1)
    monkeypatch.delenv("PATTERN", raising=False)
    assert not trec.append_to_file("pat", dump_dir=str(tmp_path))
    monkeypatch.setenv("PATTERN", "other")
    assert not trec.append_to_file("pat", dump_dir=str(tmp_path))
    monkeypatch.setenv("PATTERN", "pat")
    monkeypatch.setenv("TFHE_TPU_DUMP_DIR", str(tmp_path))
    assert trec.append_to_file("pat") and jrec.append_to_file("pat")
    for load in (TG.load_dumps, JG.load_dumps):
        recs = load(str(tmp_path / "pat.pkl"))
        assert len(recs) == 2
        for r in recs:
            assert r["values"].dtype == U64
            np.testing.assert_array_equal(r["values"], jw(jct))
            assert (r["expected_msg"], r["modulus"], r["log_ciphertext_modulus"]) == (1, 5, 64)


# ---------------------------------------------------------------------------
# the port alone, on its own keys
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(ORDERS))
def own_keys(request):
    return request.param, TG.gen_keys(ORDERS[request.param][0], seed=7, device="cpu")


def test_own_keys_gates_mvb_and_lut(own_keys):
    order, (ck, sk) = own_keys
    for name in GATES:
        g = TE.Gadget.new_canonical(*_gate_args(name))
        assert g.test_full(ck, sk), f"{name} {order}"
    enc = TE.Encoding.new_canonical(5, [0, 1, 2, 3, 4], 11)
    ct = TG.encrypt_arithmetic(ck, torch.arange(5), enc, seed=3)
    luts = [[(2 * x) % 5 for x in range(5)], [(x * x) % 5 for x in range(5)],
            [(x + 3) % 5 for x in range(5)]]
    for lut, out in zip(luts, TE.mvb(sk, ct, [enc] * 3, luts)):
        np.testing.assert_array_equal(decrypted(ck, out), lut)
    out = TE.apply_lut(sk, ct, enc, lambda x: (4 * x + 1) % 5)
    np.testing.assert_array_equal(decrypted(ck, out), [(4 * x + 1) % 5 for x in range(5)])
    inter = enc.apply_lut_to_encoding(lambda x: (4 * x + 1) % 5)
    acc = sk.accumulator(inter, enc)               # made by the call above, kept on the key
    assert acc is sk.accumulator(inter, enc)
    assert torch.equal(acc.data, TE.build_accumulator_glwe(sk.params, inter, enc, "cpu").data)
    if order == "ks_pbs":
        enc3 = TE.Encoding.new_canonical(3, [0, 1, 2], 7)
        x0, x1 = torch.tensor([0, 1, 2, 0, 2]), torch.tensor([1, 1, 0, 2, 2])
        c0 = TG.encrypt_arithmetic(ck, x0, enc3, seed=4)
        c1 = TG.encrypt_arithmetic(ck, x1, enc3, seed=5)
        f = lambda x: (x * x + 2) % 9
        hi, lo = TE.full_tree_bootstrapping(sk, [c1, c0], [enc3, enc3], 9, f)
        vals = np.array([f(int(a) + 3 * int(b)) for a, b in zip(x0, x1)])
        np.testing.assert_array_equal(decrypted(ck, hi), vals // 3)
        np.testing.assert_array_equal(decrypted(ck, lo), vals % 3)
        w16 = TE.Encoding.new_trivial_wopbs(16)
        in17 = TE.Encoding.new_canonical(16, list(range(16)), 17)
        msgs = torch.arange(16)
        out = TE.woppbs_lut(sk, TG.encrypt_arithmetic(ck, msgs, in17, seed=6), w16,
                            lambda x: (5 * x + 7) % 16)
        np.testing.assert_array_equal(decrypted(ck, out), (5 * msgs.numpy() + 7) % 16)


def test_own_keys_deep_chain(own_keys):
    """A random chain of gadget gates against the clear model (as
    tests/test_gadget.py:155 runs it on the JAX package)."""
    order, (ck, sk) = own_keys
    rs = np.random.RandomState(1234)
    gates = [TE.Gadget.new_canonical(*_gate_args(n)) for n in ("and", "or", "xor", "nand")]
    a, b = np.array([0, 1, 1, 0]), np.array([1, 1, 0, 0])
    cur = TG.encrypt_arithmetic(ck, a, gates[0].enc_in[0], seed=50)
    cb = TG.encrypt_arithmetic(ck, b, gates[0].enc_in[1], seed=51)
    clear = a.copy()
    for step in range(12):
        i = rs.randint(len(gates))
        cur = gates[i].exec(sk, [cur, cb])
        clear = np.array([gates[i].exec_clear([x, y]) for x, y in zip(clear, b)])
        np.testing.assert_array_equal(decrypted(ck, cur), clear, err_msg=f"step {step} {order}")


def test_own_keys_fresh_noise(own_keys):
    """C5: the noise of 4096 fresh encryptions measures the parameters' std
    (within 5% of it, the sample std's error ~1.1%), and every one lies
    within 8 sigma, inside tests/test_gadget.py:192-194's bound."""
    order, (ck, _) = own_keys
    enc = TE.Encoding.new_canonical(5, [0, 1, 2, 3, 4], 11)
    ct = TG.encrypt_arithmetic(ck, torch.arange(4096) % 5, enc, seed=9)
    noise = TG.measure_noise(ck, ct).astype(np.float64)
    p = ORDERS[order][0]
    std = (p.glwe_noise_std if p.encryption_key_choice == "big" else p.lwe_noise_std)
    scale = std * enc.modulus_p                 # torus units x p
    assert (np.abs(noise) < 8 * scale).all()
    assert abs(noise.std() / scale - 1) < 0.05, noise.std() / scale
    assert abs(noise.mean()) < 0.1 * scale


def test_gadget_utilities():
    g = TE.Gadget.new_canonical(*_gate_args("and"))
    assert TE.Gadget.split_int_in_booleans(5, 4) == [1, 0, 1, 0]
    assert TE.Gadget.split_int_in_booleans(5, 4, big_endian=True) == [0, 1, 0, 1]
    assert TE.Gadget.vec_bool_to_int([0, 1, 0, 1], big_endian=True) == 5
    assert g.exec_clear([1, 1]) == 1 and g.exec_clear([1, 0]) == 0
    with pytest.raises(ValueError, match="not computable"):
        TE.Gadget.new_canonical(lambda a, b: a & b, 2, [1, 1], 1, 2, 2)
    enc1 = TE.Encoding.new_canonical_binary(1, 5)
    ct = TE.trivial_encrypt(P, [1, 0], enc1, device="cpu")
    lifted = g.cast_before_gadget_from_1([ct, ct])
    assert [c.encoding for c in lifted] == g.enc_in


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.gen_keys(P, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.trivial_encrypt(P, [0], TE.Encoding.new_canonical_binary(1, 5))
