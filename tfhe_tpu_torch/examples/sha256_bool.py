"""SHA-256 over encrypted booleans (counterpart of
`tfhe_tpu/examples/sha256_bool.py`; reference tfhe/examples/sha256_bool/).

Two word forms:
  * a list of 32 `BoolCiphertext`s, LSB first: rotations and shifts are
    list reindexing, XOR/AND/mux boolean gates, addition a ripple-carry
    adder (`add_words`: one xor and one mux a bit);
  * the batched form, one BoolCiphertext [32, n+1] whose leading axis is
    the 32 bits, LSB first: every bitwise stage is one gate call on 32
    rows, and addition a Kogge–Stone parallel-prefix carry network
    (`add_words_b`: 18 dependent calls, the reference's --ladner-fischer
    mode).  `sha256_fhe` runs the whole message in this form.

Client-side padding (`pad_sha256_input`, reference padding.rs) runs on the
plaintext.  The JAX package's `clear_caches_every` option (a workaround for
its CPU backend's compile cache) has no counterpart here: the port compiles
nothing per call.  Trivial words are made on the server key's device.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .. import boolean as B
from ..core.entities import LweCiphertext

K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]

H_INIT = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

Word = List[B.BoolCiphertext]  # 32 bits, LSB first


def _bits(value: int, n: int = 32) -> List[bool]:
    return [bool((value >> i) & 1) for i in range(n)]


def encrypt_word(ck: B.ClientKey, value: int, seed: int = 0) -> Word:
    return [B.encrypt(ck, b, seed=seed * 64 + i) for i, b in enumerate(_bits(value))]


def trivial_word(params, value: int, device="cuda") -> Word:
    return [B.trivial_encrypt(params, b, device=device) for b in _bits(value)]


def decrypt_word(ck: B.ClientKey, w: Word) -> int:
    return sum(int(B.decrypt(ck, b).item()) << i for i, b in enumerate(w))


def rotr(w: Word, r: int) -> Word:
    return [w[(i + r) % 32] for i in range(32)]


def shr(w: Word, r: int, params) -> Word:
    zero = B.trivial_encrypt(params, False, device=w[0].device)
    return [w[i + r] if i + r < 32 else zero for i in range(32)]


def xor_words(sk, a: Word, b: Word) -> Word:
    return [B.xor_(sk, x, y) for x, y in zip(a, b)]


def and_words(sk, a: Word, b: Word) -> Word:
    return [B.and_(sk, x, y) for x, y in zip(a, b)]


def not_word(a: Word) -> Word:
    return [B.not_(x) for x in a]


def add_words(sk, a: Word, b: Word, params) -> Word:
    """Ripple-carry addition mod 2^32: s = a⊕b⊕c, c' = maj(a, b, c) as
    mux(a⊕b, c, a) (2 gate calls a bit after the first)."""
    out = []
    carry = None
    for i in range(32):
        axb = B.xor_(sk, a[i], b[i])
        if carry is None:
            out.append(axb)
            carry = B.and_(sk, a[i], b[i])
        else:
            out.append(B.xor_(sk, axb, carry))
            carry = B.mux(sk, axb, carry, a[i])
    return out


def big_sigma0(sk, w, params):
    return xor_words(sk, xor_words(sk, rotr(w, 2), rotr(w, 13)), rotr(w, 22))


def big_sigma1(sk, w, params):
    return xor_words(sk, xor_words(sk, rotr(w, 6), rotr(w, 11)), rotr(w, 25))


def small_sigma0(sk, w, params):
    return xor_words(sk, xor_words(sk, rotr(w, 7), rotr(w, 18)), shr(w, 3, params))


def small_sigma1(sk, w, params):
    return xor_words(sk, xor_words(sk, rotr(w, 17), rotr(w, 19)), shr(w, 10, params))


def ch(sk, e, f, g):
    """(e AND f) XOR (NOT e AND g): one mux a bit."""
    return [B.mux(sk, x, y, z) for x, y, z in zip(e, f, g)]


def maj(sk, a, b, c):
    return [B.mux(sk, B.xor_(sk, x, y), z, x) for x, y, z in zip(a, b, c)]


# ---------------------------------------------------------------------------
# client-side padding (reference padding.rs: computed over the plaintext so
# the exact message length is not revealed to the server)
# ---------------------------------------------------------------------------


def pad_sha256_data(data: bytes) -> List[bool]:
    """SHA-256 message padding: bits (MSB first per byte) + '1' + zeros +
    the 64-bit big-endian bit length, to a multiple of 512 bits."""
    bits = [bool((byte >> i) & 1) for byte in data for i in range(7, -1, -1)]
    bits.append(True)
    bits.extend([False] * ((512 - ((len(bits) + 64) % 512)) % 512))
    length = len(data) * 8
    bits.extend([bool((length >> i) & 1) for i in range(63, -1, -1)])
    return bits


def _is_valid_hex(s: str) -> bool:
    return len(s) > 0 and all(c in "0123456789abcdefABCDEF" for c in s)


def pad_sha256_input(s: str) -> List[bool]:
    """'0x'-prefixed valid hex is parsed as bytes, anything else as text
    (reference pad_sha256_input)."""
    if s.startswith("0x") and _is_valid_hex(s[2:]):
        h = s[2:]
        if len(h) % 2:
            h = "0" + h
        data = bytes.fromhex(h)
    else:
        data = s.encode()
    return pad_sha256_data(data)


def bools_to_hex(bools: Sequence[bool]) -> str:
    """MSB-first bit vector → lowercase hex (reference bools_to_hex)."""
    return "".join(format(sum(int(bools[i + j]) << (3 - j) for j in range(4)), "x")
                   for i in range(0, len(bools) - 3, 4))


# ---------------------------------------------------------------------------
# batched words: one BoolCiphertext whose leading axis is the 32 bits (LSB
# first); every bitwise stage is one gate call on 32 rows
# ---------------------------------------------------------------------------


def _bword(data: torch.Tensor) -> B.BoolCiphertext:
    return B.BoolCiphertext(lwe=LweCiphertext(data=data))


def trivial_word_b(params, value: int, device="cuda") -> B.BoolCiphertext:
    return B.trivial_encrypt(params, _bits(value), device=device)


def decrypt_word_b(ck: B.ClientKey, w: B.BoolCiphertext) -> int:
    return sum(int(b) << i for i, b in enumerate(B.decrypt(ck, w).tolist()))


def rotr_b(w, r: int):
    idx = (torch.arange(32, device=w.device) + r) % 32
    return _bword(w.lwe.data[idx])


def shr_b(w, r: int, params):
    zeros = B.trivial_encrypt(params, [False] * r, device=w.device)
    return _bword(torch.cat([w.lwe.data[r:], zeros.lwe.data]))


def _sigma_b(sk, w, r1, r2, shift_r, params, shr_last: bool):
    t3 = shr_b(w, shift_r, params) if shr_last else rotr_b(w, shift_r)
    return B.xor_(sk, B.xor_(sk, rotr_b(w, r1), rotr_b(w, r2)), t3)


def add_words_b(sk, a, b, params):
    """Addition mod 2^32 by a Kogge–Stone parallel-prefix carry network
    (the reference's --ladner-fischer mode, boolean_ops.rs): p/g setup (2
    calls), 5 levels of 3 calls, the final sum xor: 18 dependent calls of
    17 to 32 rows."""
    p = B.xor_(sk, a, b)
    g = B.and_(sk, a, b)
    gd, pd = g.lwe.data, p.lwe.data
    s = 1
    while s < 32:
        hi_g, hi_p = _bword(gd[s:]), _bword(pd[s:])
        lo_g, lo_p = _bword(gd[:-s]), _bword(pd[:-s])
        new_g = B.or_(sk, hi_g, B.and_(sk, hi_p, lo_g))
        new_p = B.and_(sk, hi_p, lo_p)
        gd = torch.cat([gd[:s], new_g.lwe.data])
        pd = torch.cat([pd[:s], new_p.lwe.data])
        s <<= 1
    # the carry into bit i is the prefix generate of bits [0, i)
    zero = B.trivial_encrypt(params, [False], device=gd.device)
    return B.xor_(sk, p, _bword(torch.cat([zero.lwe.data, gd[:31]])))


def ch_b(sk, e, f, g):
    return B.mux(sk, e, f, g)


def maj_b(sk, a, b, c):
    return B.mux(sk, B.xor_(sk, a, b), c, a)


def sha256_compress_b(sk, params, state, block_words):
    """One 64-round compression over batched words."""
    dev = sk.device
    w = list(block_words)
    for t in range(16, 64):
        s0 = _sigma_b(sk, w[t - 15], 7, 18, 3, params, True)
        s1 = _sigma_b(sk, w[t - 2], 17, 19, 10, params, True)
        w.append(add_words_b(sk, add_words_b(sk, w[t - 16], s0, params),
                             add_words_b(sk, w[t - 7], s1, params), params))
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        t1 = add_words_b(
            sk, add_words_b(sk, h, _sigma_b(sk, e, 6, 11, 25, params, False), params),
            add_words_b(sk, ch_b(sk, e, f, g),
                        add_words_b(sk, trivial_word_b(params, K[t], dev), w[t], params),
                        params), params)
        t2 = add_words_b(sk, _sigma_b(sk, a, 2, 13, 22, params, False), maj_b(sk, a, b, c),
                         params)
        h, g, f = g, f, e
        e = add_words_b(sk, d, t1, params)
        d, c, b = c, b, a
        a = add_words_b(sk, t1, t2, params)
    return [add_words_b(sk, x, y, params) for x, y in zip(state, [a, b, c, d, e, f, g, h])]


def sha256_fhe(sk, params, bits: B.BoolCiphertext) -> B.BoolCiphertext:
    """Whole-message SHA-256 (reference sha256_function.rs): `bits` is the
    padded message as one batched BoolCiphertext (MSB first, a multiple of
    512 rows: `pad_sha256_input` encrypted in one call).  → the 256 digest
    bits, MSB first, batched."""
    n_bits = bits.lwe.data.shape[0]
    if n_bits % 512:
        raise ValueError("the input must be padded to a multiple of 512 bits")
    state = [trivial_word_b(params, h, sk.device) for h in H_INIT]
    for blk in range(n_bits // 512):
        # each MSB-first 32-bit slice, flipped to an LSB-first batched word
        words = [_bword(bits.lwe.data[blk * 512 + t * 32:blk * 512 + (t + 1) * 32].flip(0))
                 for t in range(16)]
        state = sha256_compress_b(sk, params, state, words)
    return _bword(torch.cat([w.lwe.data.flip(0) for w in state]))


def sha256_compress(sk, params, state: Sequence[Word],
                    block_words: Sequence[Word]) -> List[Word]:
    """One 64-round SHA-256 compression over list-of-bits words."""
    dev = sk.device
    w = list(block_words)
    for t in range(16, 64):
        s0 = small_sigma0(sk, w[t - 15], params)
        s1 = small_sigma1(sk, w[t - 2], params)
        w.append(add_words(sk, add_words(sk, w[t - 16], s0, params),
                           add_words(sk, w[t - 7], s1, params), params))
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        t1 = add_words(sk, add_words(sk, h, big_sigma1(sk, e, params), params),
                       add_words(sk, ch(sk, e, f, g),
                                 add_words(sk, trivial_word(params, K[t], dev), w[t], params),
                                 params), params)
        t2 = add_words(sk, big_sigma0(sk, a, params), maj(sk, a, b, c), params)
        h, g, f = g, f, e
        e = add_words(sk, d, t1, params)
        d, c, b = c, b, a
        a = add_words(sk, t1, t2, params)
    return [add_words(sk, x, y, params) for x, y in zip(state, [a, b, c, d, e, f, g, h])]
