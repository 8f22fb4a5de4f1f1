"""FHE Trivium / Kreyvium stream ciphers and the client side of
transciphering (counterpart of `tfhe_tpu/apps/trivium.py`; reference
apps/trivium/src/: trivium_bool.rs, kreyvium_bool.rs, trivium_shortint.rs,
trivium_byte.rs, trans_ciphering/mod.rs).

Three representations of the 288-bit state:
  * booleans (`TriviumStream`, `KreyviumStream`): a clock is 3 AND and 11
    XOR gates, each one KS + PBS of the boolean scheme, in dependency order;
    streams ride the batch axis (key bits [S, n+1]; trivial cells [n+1]
    broadcast);
  * shortint bits (`TriviumStreamShortint`, `KreyviumStreamShortint`): 64
    clocks at a time (`step_64`), every AND of a round in one stacked
    bivariate PBS call and every parity in one message-extract call;
  * bytes (`TriviumStreamByte`, `KreyviumStreamByte`): clear ints (the
    client's model), or 8-bit radix ciphertexts on an `integer.ServerKey`.

Trivial cells are made on the server key's device.  Transciphering
(`trans_encrypt_64`, reference trans_ciphering/mod.rs) XORs an FheUint64
with 64 keystream bits: the shortint streams cast their bit pairs into the
high-level API's parameters through a `shortint.KeySwitchingKey`
(`cast_ksk`, with the hlapi `ServerKey` as `hl_server_key`); the byte
streams assemble 8 FheUint8 bytes on their own integer key.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .. import boolean as B
from .. import shortint
from ..core.entities import LweCiphertext
from ..integer.ciphertext import RadixCiphertext



def _xor3(sk, a, b, c):
    return B.xor_(sk, B.xor_(sk, a, b), c)


class TriviumStream:
    """Encrypted Trivium (reference TriviumStreamBool, trivium_bool.rs).

    key: 80 BoolCiphertexts (or clear bools, trivially encrypted); iv: 80
    clear bools.  `warmup_rounds` defaults to the spec's 1152 and may be cut
    for tests (the clear models take the same argument)."""

    KEY_BITS = 80
    IV_BITS = 80

    def __init__(self, sk: B.ServerKey, key_bits: Sequence, iv_bits: Sequence[int],
                 params=None, warmup_rounds: int = 4 * 288):
        self.sk = sk
        params = params or sk.params
        trivial = lambda v: B.trivial_encrypt(params, bool(v), device=sk.device)
        enc_key = [b if isinstance(b, B.BoolCiphertext) else trivial(b) for b in key_bits]
        zeros = trivial(False)
        ones = trivial(True)
        # key[i]/iv[i] follow the reference convention (bit i of the eSTREAM
        # byte stream, LSB first within bytes); the flat state keeps the
        # newest bit at s[0], so the loaded segments are reversed
        key_f = list(enc_key) + [zeros] * (self.KEY_BITS - len(enc_key))
        iv_f = [trivial(b) for b in iv_bits] + [zeros] * (self.IV_BITS - len(iv_bits))
        # registers: A = 93 (key, reversed), B = 84 (iv, reversed), C = 111
        self.state: List[B.BoolCiphertext] = (
            key_f[::-1] + [zeros] * 13
            + iv_f[::-1] + [zeros] * 4
            + [zeros] * 108 + [ones] * 3)
        for _ in range(warmup_rounds):
            self._clock()

    def _clock(self) -> B.BoolCiphertext:
        s = self.state
        sk = self.sk
        t1 = B.xor_(sk, s[65], s[92])
        t2 = B.xor_(sk, s[161], s[176])
        t3 = B.xor_(sk, s[242], s[287])
        z = _xor3(sk, t1, t2, t3)
        a1 = B.and_(sk, s[90], s[91])
        a2 = B.and_(sk, s[174], s[175])
        a3 = B.and_(sk, s[285], s[286])
        new_a = _xor3(sk, t3, a3, s[68])
        new_b = _xor3(sk, t1, a1, s[170])
        new_c = _xor3(sk, t2, a2, s[263])
        self.state = [new_a] + s[:92] + [new_b] + s[93:176] + [new_c] + s[177:287]
        return z

    def next_bit(self) -> B.BoolCiphertext:
        return self._clock()

    def next_bits(self, n: int) -> List[B.BoolCiphertext]:
        return [self._clock() for _ in range(n)]


class KreyviumStream(TriviumStream):
    """Encrypted Kreyvium (reference kreyvium_bool.rs): Trivium with a
    128-bit key and IV and two rotating registers feeding the feedback."""

    KEY_BITS = 128
    IV_BITS = 128

    def __init__(self, sk: B.ServerKey, key_bits, iv_bits, params=None,
                 warmup_rounds: int = 4 * 288):
        params = params or sk.params
        trivial = lambda v: B.trivial_encrypt(params, bool(v), device=sk.device)
        enc_key = [b if isinstance(b, B.BoolCiphertext) else trivial(b) for b in key_bits]
        if len(enc_key) != 128 or len(iv_bits) != 128:
            raise ValueError("Kreyvium takes a 128-bit key and a 128-bit IV")
        self.sk = sk
        zeros = trivial(False)
        ones = trivial(True)
        enc_iv = [trivial(b) for b in iv_bits]
        self.k_reg = list(enc_key[::-1])            # K* taps key[127], key[126], ...
        self.iv_reg = list(enc_iv[::-1])
        # A = key[35:128] reversed; B = iv[44:128] reversed; C = iv[0:44]
        # reversed + 66 ones + one zero (newest at s[0])
        self.state = (enc_key[35:][::-1] + enc_iv[44:][::-1] + enc_iv[:44][::-1]
                      + [ones] * 66 + [zeros])
        for _ in range(warmup_rounds):
            self._clock()

    def _clock(self) -> B.BoolCiphertext:
        s = self.state
        sk = self.sk
        k_out = self.k_reg[0]
        iv_out = self.iv_reg[0]
        self.k_reg = self.k_reg[1:] + [k_out]
        self.iv_reg = self.iv_reg[1:] + [iv_out]
        t1 = B.xor_(sk, s[65], s[92])
        t2 = B.xor_(sk, s[161], s[176])
        t3 = _xor3(sk, s[242], s[287], k_out)
        z = _xor3(sk, t1, t2, t3)
        a1 = B.and_(sk, s[90], s[91])
        a2 = B.and_(sk, s[174], s[175])
        a3 = B.and_(sk, s[285], s[286])
        new_a = _xor3(sk, t3, a3, s[68])
        new_b = _xor3(sk, B.xor_(sk, t1, a1), s[170], iv_out)
        new_c = _xor3(sk, t2, a2, s[263])
        self.state = [new_a] + s[:92] + [new_b] + s[93:176] + [new_c] + s[177:287]
        return z


# ---------------------------------------------------------------------------
# clear models (for tests and for the client-side keystream)
# ---------------------------------------------------------------------------


def clear_trivium_keystream(key_bits, iv_bits, n: int,
                            warmup_rounds: int = 4 * 288) -> List[int]:
    key_f = list(key_bits) + [0] * (80 - len(key_bits))
    iv_f = list(iv_bits) + [0] * (80 - len(iv_bits))
    s = key_f[::-1] + [0] * 13 + iv_f[::-1] + [0] * 4 + [0] * 108 + [1, 1, 1]
    out = []
    for r in range(warmup_rounds + n):
        t1 = s[65] ^ s[92]
        t2 = s[161] ^ s[176]
        t3 = s[242] ^ s[287]
        z = t1 ^ t2 ^ t3
        new_a = t3 ^ (s[285] & s[286]) ^ s[68]
        new_b = t1 ^ (s[90] & s[91]) ^ s[170]
        new_c = t2 ^ (s[174] & s[175]) ^ s[263]
        s = [new_a] + s[:92] + [new_b] + s[93:176] + [new_c] + s[177:287]
        if r >= warmup_rounds:
            out.append(z)
    return out


def clear_kreyvium_keystream(key_bits, iv_bits, n: int,
                             warmup_rounds: int = 4 * 288) -> List[int]:
    key_bits = list(key_bits)
    iv_bits = list(iv_bits)
    s = key_bits[35:][::-1] + iv_bits[44:][::-1] + iv_bits[:44][::-1] + [1] * 66 + [0]
    k_reg = key_bits[::-1]
    iv_reg = iv_bits[::-1]
    out = []
    for r in range(warmup_rounds + n):
        k_out, k_reg = k_reg[0], k_reg[1:] + [k_reg[0]]
        iv_out, iv_reg = iv_reg[0], iv_reg[1:] + [iv_reg[0]]
        t1 = s[65] ^ s[92]
        t2 = s[161] ^ s[176]
        t3 = s[242] ^ s[287] ^ k_out
        z = t1 ^ t2 ^ t3
        new_a = t3 ^ (s[285] & s[286]) ^ s[68]
        new_b = t1 ^ (s[90] & s[91]) ^ s[170] ^ iv_out
        new_c = t2 ^ (s[174] & s[175]) ^ s[263]
        s = [new_a] + s[:92] + [new_b] + s[93:176] + [new_c] + s[177:287]
        if r >= warmup_rounds:
            out.append(z)
    return out


# ---------------------------------------------------------------------------
# shortint representation (reference trivium_shortint.rs / kreyvium_shortint.rs)
# ---------------------------------------------------------------------------


def _stack_short(cts):
    """Same-metadata shortint ciphertexts stacked on a new leading axis: the
    64 independent steps of a round become one batched PBS call."""
    return cts[0].with_(lwe=LweCiphertext(data=torch.stack([c.lwe.data for c in cts])),
                        degree=max(c.degree for c in cts),
                        noise_level=max(c.noise_level for c in cts))


def _unstack_short(ct, n):
    return [ct.with_(lwe=LweCiphertext(data=ct.lwe.data[i])) for i in range(n)]


def _cat_short(cts):
    return cts[0].with_(lwe=LweCiphertext(data=torch.cat([c.lwe.data for c in cts])),
                        degree=max(c.degree for c in cts),
                        noise_level=max(c.noise_level for c in cts))


def _split3(ct):
    """A [192, ...] call's output as its three [64, ...] parts."""
    return _unstack_short(ct.with_(lwe=LweCiphertext(
        data=ct.lwe.data.reshape((3, 64) + tuple(ct.lwe.data.shape[1:])))), 3)



class TriviumStreamShortint:
    """Trivium over shortint bits (reference TriviumStreamShortint,
    apps/trivium/src/trivium/trivium_shortint.rs:10-27).

    Each register cell is a shortint ciphertext holding one bit: XOR is an
    unchecked add then a parity message extract, AND a bivariate PBS.
    Trivium's feedback distance (>= 64) makes 64 consecutive steps
    independent, so `next_64` is four stacked PBS calls.  The parameters
    need message_modulus 2 with at least 2 carry bits (sums of up to 7 bits
    stay in range)."""

    KEY_BITS = 80

    def __init__(self, key, iv, sk, cast_ksk=None, hl_server_key=None,
                 warmup_rounds: int = 18):
        if len(key) != self.KEY_BITS or len(iv) != self.KEY_BITS:
            raise ValueError(f"Trivium takes {self.KEY_BITS} key and IV bits")
        self.sk = sk
        self.cast_ksk, self.hl_server_key = cast_ksk, hl_server_key
        triv = sk.create_trivial
        enc_key = [b if isinstance(b, shortint.Ciphertext) else triv(int(b)) for b in key]
        zero = triv(0)
        # index 0 = newest (the cell order of the flat boolean state)
        self.a = enc_key[::-1] + [zero] * 13
        self.b = [triv(int(v)) for v in iv][::-1] + [zero] * 4
        self.c = [zero] * 108 + [triv(1)] * 3
        for _ in range(warmup_rounds):
            self.next_64()

    def _taps(self, reg, base, n=64):
        return _stack_short([reg[base - k] for k in range(n)])

    @staticmethod
    def step_64(sk, a, b, c):
        """One 64-step round over register lists (newest first), with no
        state of its own: → (new_a, new_b, new_c, out64)."""
        T = lambda reg, base: _stack_short([reg[base - k] for k in range(64)])
        temp_a = sk.unchecked_add(T(a, 65), T(a, 92))
        temp_b = sk.unchecked_add(T(b, 68), T(b, 83))
        temp_c = sk.unchecked_add(T(c, 65), T(c, 110))
        # the three register ANDs in one stacked bivariate PBS
        and_c, and_a, and_b = _split3(sk.unchecked_bitand(
            _cat_short([T(c, 109), T(a, 91), T(b, 82)]),
            _cat_short([T(c, 108), T(a, 90), T(b, 81)])))
        # the three feedbacks in one stacked parity extract
        new_a, new_b, new_c = _split3(sk.message_extract(_cat_short([
            sk.unchecked_add(sk.unchecked_add(and_c, T(a, 68)), temp_c),
            sk.unchecked_add(sk.unchecked_add(and_a, T(b, 77)), temp_a),
            sk.unchecked_add(sk.unchecked_add(and_b, T(c, 86)), temp_b)])))
        # the output parity of all six taps in one extract
        o = sk.message_extract(sk.unchecked_add(sk.unchecked_add(temp_a, temp_b), temp_c))
        a = _unstack_short(new_a, 64)[::-1] + a[:len(a) - 64]
        b = _unstack_short(new_b, 64)[::-1] + b[:len(b) - 64]
        c = _unstack_short(new_c, 64)[::-1] + c[:len(c) - 64]
        return a, b, c, _unstack_short(o, 64)

    def next_64(self):
        """64 keystream bits (shortint ciphertexts, stream order)."""
        self.a, self.b, self.c, out = self.step_64(self.sk, self.a, self.b, self.c)
        return out

    def trans_encrypt_64(self, cipher):
        """XOR an FheUint64 with the next 64 keystream bits (reference
        TransCiphering::trans_encrypt_64, trans_ciphering/mod.rs:44-73):
        the bits pair 2 by 2, cast through `cast_ksk` into the high-level
        API's parameters, as 32 radix blocks."""
        return _transcipher_from_shortint_stream(self.next_64(), cipher, self.sk,
                                                 self.cast_ksk, self.hl_server_key)

    trans_decrypt_64 = trans_encrypt_64


class KreyviumStreamShortint(TriviumStreamShortint):
    """Kreyvium over shortint bits (reference kreyvium_shortint.rs): Trivium
    plus the two rotating 128-bit key and IV registers."""

    KEY_BITS = 128

    def __init__(self, key, iv, sk, cast_ksk=None, hl_server_key=None,
                 warmup_rounds: int = 18):
        if len(key) != 128 or len(iv) != 128:
            raise ValueError("Kreyvium takes a 128-bit key and a 128-bit IV")
        self.sk = sk
        self.cast_ksk, self.hl_server_key = cast_ksk, hl_server_key
        triv = sk.create_trivial
        enc_key = [b if isinstance(b, shortint.Ciphertext) else triv(int(b)) for b in key]
        enc_iv = [triv(int(v)) for v in iv]
        self.k_reg = list(enc_key[::-1])
        self.iv_reg = list(enc_iv[::-1])
        self.a = enc_key[35:][::-1]
        self.b = enc_iv[44:][::-1]
        self.c = enc_iv[:44][::-1] + [triv(1)] * 66 + [triv(0)]
        for _ in range(warmup_rounds):
            self.next_64()

    def next_64(self):
        sk = self.sk
        a, b, c = self.a, self.b, self.c
        T = self._taps
        k_out = _stack_short(self.k_reg[:64])
        iv_out = _stack_short(self.iv_reg[:64])
        self.k_reg = self.k_reg[64:] + self.k_reg[:64]
        self.iv_reg = self.iv_reg[64:] + self.iv_reg[:64]
        temp_a = sk.unchecked_add(T(a, 65), T(a, 92))
        temp_b = sk.unchecked_add(T(b, 68), T(b, 83))
        temp_c = sk.unchecked_add(sk.unchecked_add(T(c, 65), T(c, 110)), k_out)
        and_c, and_a, and_b = _split3(sk.unchecked_bitand(
            _cat_short([T(c, 109), T(a, 91), T(b, 82)]),
            _cat_short([T(c, 108), T(a, 90), T(b, 81)])))
        new_a, new_b, new_c = _split3(sk.message_extract(_cat_short([
            sk.unchecked_add(sk.unchecked_add(and_c, T(a, 68)), temp_c),
            sk.unchecked_add(sk.unchecked_add(sk.unchecked_add(and_a, T(b, 77)), temp_a),
                             iv_out),
            sk.unchecked_add(sk.unchecked_add(and_b, T(c, 86)), temp_b)])))
        o = sk.message_extract(sk.unchecked_add(sk.unchecked_add(temp_a, temp_b), temp_c))
        self.a = _unstack_short(new_a, 64)[::-1] + a[:len(a) - 64]
        self.b = _unstack_short(new_b, 64)[::-1] + b[:len(b) - 64]
        self.c = _unstack_short(new_c, 64)[::-1] + c[:len(c) - 64]
        return _unstack_short(o, 64)


# ---------------------------------------------------------------------------
# byte representation (reference trivium_byte.rs + static_byte_deque.rs)
# ---------------------------------------------------------------------------


class TriviumStreamByte:
    """Trivium with bytes as the storage unit (reference TriviumStreamByte,
    generic over u8 and FheUint8).

    Register bytes store 8 consecutive stream bits MSB first (newest bit at
    the MSB), so the reference's sliding-window reconstruction
    `byte(i) = deque[i/8] << i%8 | deque[i/8+1] >> (8 - i%8)`
    (static_byte_deque.rs:71-81) gives keystream bytes whose bit p is
    stream bit 8b+p: the LSB-first byte packing of the eSTREAM vectors.

    With `server_key` (an `integer.ServerKey`), values are 8-bit
    RadixCiphertexts and the 8 byte-steps of `next_64` run stacked on the
    radix batch axis; without it, values are plain ints (the clear model,
    also the client's)."""

    KEY_BYTES = 10
    A_BYTES, B_BYTES, C_BYTES = 12, 11, 14
    C_INIT = 14   # 0b00001110: the three ones at the start of register c

    def __init__(self, key_bytes, iv_bytes, server_key=None, warmup_rounds: int = 18):
        if len(key_bytes) != self.KEY_BYTES or len(iv_bytes) != self.KEY_BYTES:
            raise ValueError(f"Trivium takes {self.KEY_BYTES} key and IV bytes")
        isk = self.isk = server_key
        self._nb = None
        if isk is not None:
            self._nb = key_bytes[0].num_blocks
            key_vals = list(key_bytes)
            triv = lambda v: isk.create_trivial_radix(int(v), self._nb)
            iv_vals = [triv(v) for v in iv_bytes]
            zero = triv(0)
            c0 = triv(self.C_INIT)
        else:
            key_vals = [int(k) & 0xFF for k in key_bytes]
            iv_vals = [int(v) & 0xFF for v in iv_bytes]
            zero, c0 = 0, self.C_INIT
        # index 0 = newest byte; key byte 9 is the newest of register a
        self.a = key_vals[::-1] + [zero, zero]
        self.b = iv_vals[::-1] + [zero]
        self.c = [zero] * 13 + [c0]
        for _ in range(warmup_rounds):
            self.next_64()

    # -- generic byte ops ---------------------------------------------------

    def _win(self, reg, base):
        """Stacked window bytes byte(base - 8b) for the 8 byte-steps b."""
        w0, s = divmod(base, 8)
        lo = self._stack([reg[w0 - bb] for bb in range(8)])
        if s == 0:
            return lo
        hi = self._stack([reg[w0 - bb + 1] for bb in range(8)])
        return self._or(self._shl(lo, s), self._shr(hi, 8 - s))

    def _stack(self, vals):
        if self.isk is None:
            return vals
        blocks = []
        for i in range(self._nb):
            data = torch.stack([v.blocks[i].lwe.data for v in vals])
            blocks.append(vals[0].blocks[i].with_(
                lwe=LweCiphertext(data=data),
                degree=max(v.blocks[i].degree for v in vals),
                noise_level=max(v.blocks[i].noise_level for v in vals)))
        return type(vals[0])(blocks=blocks)

    def _unstack(self, val, n):
        if self.isk is None:
            return val
        return [type(val)(blocks=[blk.with_(lwe=LweCiphertext(data=blk.lwe.data[i]))
                                  for blk in val.blocks]) for i in range(n)]

    def _shl(self, v, s):
        if self.isk is None:
            return [(x << s) & 0xFF for x in v]
        return self.isk.scalar_left_shift(v, s)

    def _shr(self, v, s):
        if self.isk is None:
            return [x >> s for x in v]
        return self.isk.scalar_right_shift(v, s)

    def _or(self, x, y):
        if self.isk is None:
            return [a | b for a, b in zip(x, y)]
        return self.isk.bitor(x, y)

    def _xor(self, x, y):
        if self.isk is None:
            return [a ^ b for a, b in zip(x, y)]
        return self.isk.bitxor(x, y)

    def _and(self, x, y):
        if self.isk is None:
            return [a & b for a, b in zip(x, y)]
        return self.isk.bitand(x, y)

    def _push(self, reg, v):
        return self._unstack(v, 8)[::-1] + reg[:len(reg) - 8]

    # -- the cipher ---------------------------------------------------------

    def next_64(self):
        """8 keystream bytes (64 bits, LSB first within bytes).  The 8
        byte-steps are independent (feedback distance >= 64) and run
        stacked (reference get_64_output_and_values, trivium_byte.rs:181)."""
        n7 = 7    # taps evaluated at n = 8b + 7, offsets shifted per block
        a1, a2, a3, a4, a5 = (self._win(self.a, t - n7) for t in (91, 90, 68, 65, 92))
        b1, b2, b3, b4, b5 = (self._win(self.b, t - n7) for t in (82, 81, 77, 68, 83))
        c1, c2, c3, c4, c5 = (self._win(self.c, t - n7) for t in (109, 108, 86, 65, 110))
        temp_a = self._xor(a4, a5)
        temp_b = self._xor(b4, b5)
        temp_c = self._xor(c4, c5)
        a_and = self._and(a1, a2)
        b_and = self._and(b1, b2)
        c_and = self._and(c1, c2)
        o = self._xor(self._xor(temp_a, temp_b), temp_c)
        new_a = self._xor(temp_c, self._xor(c_and, a3))
        new_b = self._xor(temp_a, self._xor(a_and, b3))
        new_c = self._xor(temp_b, self._xor(b_and, c3))
        self.a = self._push(self.a, new_a)
        self.b = self._push(self.b, new_b)
        self.c = self._push(self.c, new_c)
        return list(self._unstack(o, 8))

    def trans_encrypt_64(self, cipher):
        """XOR an FheUint64 with the keystream of the next 8 FheUint8 bytes
        (reference transcipher_from_fheu8_stream, trans_ciphering/mod.rs:21):
        each byte widened to the cipher's blocks and shifted to its place."""
        if self.isk is None:
            raise ValueError("transciphering needs the encrypted (FheUint8) stream")
        acc = None
        for i, byte in enumerate(self.next_64()):
            wide = self.isk.scalar_left_shift(self.isk.cast_to_size(byte, cipher.ct.num_blocks),
                                              8 * i)
            acc = wide if acc is None else self.isk.bitor(acc, wide)
        return type(cipher)(self.isk.bitxor(cipher.ct, acc))

    trans_decrypt_64 = trans_encrypt_64


class KreyviumStreamByte(TriviumStreamByte):
    """Kreyvium with byte storage (reference kreyvium_byte.rs): a 128-bit
    key and IV; the k* and iv* rotating registers become a cyclic list of 16
    "output" bytes whose bit p is the register's output at step 8b+p (for
    the key, the bit-reversed key bytes: one batched LUT at init).

    key_bytes: 16 ints or 8-bit RadixCiphertexts (eSTREAM byte order, bits
    LSB first); iv_bytes: 16 clear ints."""

    KEY_BYTES = 16
    A_BYTES, B_BYTES, C_BYTES = 12, 11, 14

    def __init__(self, key_bytes, iv_bytes, server_key=None, warmup_rounds: int = 18):
        if len(key_bytes) != 16 or len(iv_bytes) != 16:
            raise ValueError("Kreyvium takes 16 key and IV bytes")
        isk = self.isk = server_key
        self._nb = None
        iv_ints = [int(v) & 0xFF for v in iv_bytes]
        ib = _lsb_bits_of_bytes(iv_ints)
        if isk is not None:
            self._nb = key_bytes[0].num_blocks
            key_vals = list(key_bytes)
            triv = lambda v: isk.create_trivial_radix(int(v) & 0xFF, self._nb)
            # register a = key bytes 15..4 verbatim (s[j] = key[127-j] makes
            # deque byte w == key byte 15-w); byte 11 keeps only its top 5
            # bits (a 93-bit register, 3 pad zeros)
            self.a = [key_vals[15 - w] for w in range(11)] + [
                isk.scalar_bitand(key_vals[4], 0xF8)]
            self.b = [triv(v) for v in _reg_bytes_from_bits(ib[44:][::-1])]
            self.c = [triv(v) for v in _reg_bytes_from_bits(ib[:44][::-1] + [1] * 66 + [0])]
            # k-output bytes: bit p at block b = key[127-8b-p] = bitrev(key byte 15-b)
            self.k_out = [self._bitrev(key_vals[15 - b]) for b in range(16)]
            self.iv_out = [triv(_bitrev_int(iv_ints[15 - b])) for b in range(16)]
        else:
            key_ints = [int(k) & 0xFF for k in key_bytes]
            kb = _lsb_bits_of_bytes(key_ints)
            self.a = _reg_bytes_from_bits(kb[35:][::-1])
            self.b = _reg_bytes_from_bits(ib[44:][::-1])
            self.c = _reg_bytes_from_bits(ib[:44][::-1] + [1] * 66 + [0])
            self.k_out = [_bitrev_int(key_ints[15 - b]) for b in range(16)]
            self.iv_out = [_bitrev_int(iv_ints[15 - b]) for b in range(16)]
        for _ in range(warmup_rounds):
            self.next_64()

    def _bitrev(self, v):
        """Bit-reverse an 8-bit radix ciphertext: reverse the block list and
        the bit order inside each block with one LUT."""
        blocks = list(v.blocks)[::-1]
        bits = blocks[0].message_modulus.bit_length() - 1
        sk = self.isk.key
        lut = sk.generate_lookup_table(lambda x: int(f"{x % (1 << bits):0{bits}b}"[::-1], 2))
        return type(v)(blocks=[sk.apply_lookup_table(blk, lut) for blk in blocks])

    def _rot_out(self, reg):
        stacked = self._stack(reg[:8]) if self.isk is not None else reg[:8]
        return stacked, reg[8:] + reg[:8]

    def next_64(self):
        k_out, self.k_out = self._rot_out(self.k_out)
        iv_out, self.iv_out = self._rot_out(self.iv_out)
        a1, a2, a3, a4, a5 = (self._win(self.a, t - 7) for t in (91, 90, 68, 65, 92))
        b1, b2, b3, b4, b5 = (self._win(self.b, t - 7) for t in (82, 81, 77, 68, 83))
        c1, c2, c3, c4, c5 = (self._win(self.c, t - 7) for t in (109, 108, 86, 65, 110))
        temp_a = self._xor(a4, a5)
        temp_b = self._xor(b4, b5)
        temp_c = self._xor(self._xor(c4, c5), k_out)
        a_and = self._and(a1, a2)
        b_and = self._and(b1, b2)
        c_and = self._and(c1, c2)
        o = self._xor(self._xor(temp_a, temp_b), temp_c)
        new_a = self._xor(temp_c, self._xor(c_and, a3))
        new_b = self._xor(self._xor(temp_a, self._xor(a_and, b3)), iv_out)
        new_c = self._xor(temp_b, self._xor(b_and, c3))
        self.a = self._push(self.a, new_a)
        self.b = self._push(self.b, new_b)
        self.c = self._push(self.c, new_c)
        return list(self._unstack(o, 8))


def _lsb_bits_of_bytes(byte_vals):
    """eSTREAM bytes → bit list (bit 8w+j = byte w's bit j, LSB first)."""
    return [(int(v) >> j) & 1 for v in byte_vals for j in range(8)]


def _reg_bytes_from_bits(s_bits):
    """State-bit list (s[0] = newest) → deque bytes, MSB-first packing
    (byte w bit p = s[8w + 7 - p]), zero-padded."""
    out = []
    for w in range(0, len(s_bits), 8):
        chunk = s_bits[w:w + 8] + [0] * (8 - len(s_bits[w:w + 8]))
        out.append(sum(b << (7 - j) for j, b in enumerate(chunk)))
    return out


def _bitrev_int(v):
    return int(f"{int(v) & 0xFF:08b}"[::-1], 2)


# ---------------------------------------------------------------------------
# transciphering, the client side (reference trans_ciphering/mod.rs)
# ---------------------------------------------------------------------------


def _transcipher_from_shortint_stream(stream_bits, cipher, internal_sk, cast_ksk,
                                      hl_server_key):
    """64 shortint keystream bits → cipher XOR their FheUint64 mask
    (reference transcipher_from_1_1_stream, trans_ciphering/mod.rs:44-73):
    block j is bits 2j + 2 * bits (2j+1), cast in one batched call."""
    if len(stream_bits) != 64:
        raise ValueError(f"transciphering takes 64 keystream bits, not {len(stream_bits)}")
    if cast_ksk is None or hl_server_key is None:
        raise ValueError("transciphering needs the casting key and the hlapi server key")
    lows = _stack_short([stream_bits[2 * j] for j in range(32)])
    highs = _stack_short([stream_bits[2 * j + 1] for j in range(32)])
    pairs = internal_sk.unchecked_add(lows, internal_sk.unchecked_scalar_mul(highs, 2))
    mask = RadixCiphertext(blocks=_unstack_short(cast_ksk.cast(pairs), 32))
    isk = getattr(hl_server_key, "radix", hl_server_key)
    return type(cipher)(isk.bitxor(cipher.ct, mask))


def trans_encrypt_u64(value: int, keystream_bits: Sequence[int]) -> int:
    """Client side: XOR-mask a u64 with 64 clear keystream bits (bit i of
    the mask = keystream bit i, LSB first)."""
    mask = 0
    for i, b in enumerate(keystream_bits[:64]):
        mask |= (int(b) & 1) << i
    return (int(value) ^ mask) & ((1 << 64) - 1)


def trans_decrypt_u64_bits(masked: int, stream: TriviumStream):
    """Boolean-stream transciphering: 64 encrypted keystream bits, with the
    masked clear value XORed in (a NOT where its bit is 1): the 64 encrypted
    plaintext bits, LSB first."""
    ks = stream.next_bits(64)
    return [B.not_(ks[i]) if (masked >> i) & 1 else ks[i] for i in range(64)]
