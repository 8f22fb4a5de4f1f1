"""The port's AES-128-CTR CSPRNG (`tfhe_tpu_torch.native`, its own copy of
csprng.cpp built by g++ at first use into tfhe_tpu_torch/build/): the
FIPS-197 vectors on both backends, determinism across chunkings, forks, and
byte equality with the JAX package's generator (`tfhe_tpu.native`) for the
same seed and fork indices, down several levels of the fork tree."""
import shutil
from pathlib import Path

import pytest

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

SEED = b"0123456789abcdef"


@pytest.fixture(scope="module")
def native():
    from tfhe_tpu_torch import native
    return native


def test_built_outside_the_package(native):
    so = native.build_csprng()
    pkg = Path(native.__file__).resolve().parent
    assert so.parent == pkg.parent / "build" and so.exists()
    assert not list(pkg.glob("*.so"))


def test_aes_fips197_vectors(native):
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    pt = bytes.fromhex("3243f6a8885a308d313198a2e0370734")
    assert native.aes128_encrypt_block(key, pt).hex() == "3925841d02dc09fbdc118597196a0b32"
    key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    assert native.backend() in ("aesni", "soft")
    for enc in (native.aes128_encrypt_block, native.aes128_encrypt_block_soft):
        assert enc(key, pt).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"   # FIPS-197 C.1


def test_stream_determinism_and_chunking(native):
    a = native.AesCtrGenerator(SEED).generate(100)
    g = native.AesCtrGenerator(SEED)
    assert a == b"".join(g.generate(n) for n in (1, 7, 16, 76))
    assert native.AesCtrGenerator(b"another-seed-16b").generate(100) != a
    with pytest.raises(ValueError, match="16 bytes"):
        native.AesCtrGenerator(b"short")


def test_forks(native):
    def make():
        g = native.AesCtrGenerator(SEED)
        g.generate(10)
        return g
    c = make().fork(3).generate(16)
    assert make().fork(3).generate(16) == c
    assert make().fork(4).generate(16) != c
    assert native.AesCtrGenerator(b"another-seed-16b").fork(3).generate(16) != c


@pytest.mark.parametrize("seed", [SEED, bytes(16), bytes(range(240, 256))])
def test_streams_equal_the_jax_packages(native, seed):
    jnative = pytest.importorskip("tfhe_tpu.native")
    mine, theirs = native.AesCtrGenerator(seed), jnative.AesCtrGenerator(seed)
    assert mine.generate(4099) == theirs.generate(4099)
    for path in ((0,), (5, 1), (2, 0, 7)):
        a, b = mine, theirs
        for i in path:
            a, b = a.fork(i), b.fork(i)
        assert a.generate(1000) == b.generate(1000), path
    assert mine.generate(33) == theirs.generate(33)
