"""The port's threefry streams (`tfhe_tpu_torch.core.threefry`) bit for bit
against `tfhe_tpu.core.rng` (jax.random, threefry partitionable): keys from
seeds with bit 31 set and at 2^32 - 1, fork paths through 0x3E, 0xB0B and
0xB0C, splits, and `uniform_torus` and `binary_key` over odd and
multi-axis shapes, under one key and under a batch of keys, in passes of
any size and over row ranges."""
import jax
import numpy as np
import pytest
import torch

from tfhe_tpu.core import rng as J
from tfhe_tpu_torch.core import threefry as T

SEEDS = (0, 1, 2 ** 31 + 1, 0xFFFFFFFF, 2 ** 32 + 7)
SHAPES = ((1,), (5,), (3, 7), (2, 3, 5), (33, 65), (4, 1, 3))
FORKS = ((0x3E,), (0xB0B,), (0xB0C,), (0xB0B, 0x5C), (2 ** 31 + 5,), (0xFFFFFFFF, 0))


def words(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(np.int64))


def u64(a) -> np.ndarray:
    return np.asarray(a).view(np.int64)


def test_threefry2x32_known_answers():
    """Random123's known-answer vectors for Threefry-2x32 with 20 rounds."""
    cases = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0))]
    for (k0, k1), (x0, x1), want in cases:
        t = lambda v: torch.tensor([v], dtype=torch.int64)
        out = T.threefry2x32(t(k0), t(k1), t(x0), t(x1))
        assert (int(out[0]), int(out[1])) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_forks_and_splits(seed):
    jk, tk = J.key_from_seed(seed), T.key_from_seed(seed, "cpu")
    assert torch.equal(words(jk), tk)
    for path in FORKS:
        assert torch.equal(words(J.fork(jk, *path)), T.fork(tk, *path)), path
    for n in (1, 2, 3, 7):
        assert torch.equal(words(J.split(jk, n)), T.split(tk, n))
    # partitionable threefry: a split key is the fold-in of its index
    assert torch.equal(T.split(tk, 3)[1], T.fold_in(tk, 1))
    assert torch.equal(words(jax.random.fold_in(jk, 1)), T.fold_in(tk, 1))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_torus_and_binary_key(seed, shape):
    jk = J.fork(J.key_from_seed(seed), 0x3E)
    tk = T.fork(T.key_from_seed(seed, "cpu"), 0x3E)
    np.testing.assert_array_equal(T.uniform_torus(tk, shape).numpy(),
                                  u64(J.uniform_torus(jk, shape, 64)))
    np.testing.assert_array_equal(T.binary_key(tk, shape).numpy(),
                                  np.asarray(J.binary_key(jk, shape)).astype(np.int64))


def test_top_bits_set():
    """Torus words with bit 63 set come out as negative int64 patterns of
    the same bits."""
    got = T.uniform_torus(T.key_from_seed(2 ** 31 + 1, "cpu"), (64,))
    want = u64(J.uniform_torus(J.key_from_seed(2 ** 31 + 1), (64,), 64))
    assert (got < 0).any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [T.CHUNK, 64, 7, 1])
def test_batched_keys_in_passes_and_row_ranges(chunk, monkeypatch):
    monkeypatch.setattr(T, "CHUNK", chunk)
    jkeys = J.split(J.key_from_seed(0xB0B), 6)
    tkeys = T.split(T.key_from_seed(0xB0B, "cpu"), 6).view(2, 3, 2)
    want = u64(jax.vmap(lambda k: J.uniform_torus(k, (3, 4), 64))(jkeys)).reshape(2, 3, 3, 4)
    np.testing.assert_array_equal(T.uniform_torus(tkeys, (3, 4)).numpy(), want)
    bits = np.asarray(jax.vmap(lambda k: J.binary_key(k, (5, 3)))(jkeys)).astype(np.int64)
    np.testing.assert_array_equal(T.binary_key(tkeys, (5, 3)).numpy(), bits.reshape(2, 3, 5, 3))
    one = u64(J.uniform_torus(J.key_from_seed(3), (40, 3, 9), 64))
    key = T.key_from_seed(3, "cpu")
    np.testing.assert_array_equal(T.uniform_torus(key, (40, 3, 9), rows=(5, 17)).numpy(),
                                  one[5:17])
    out = torch.zeros((40, 3, 10), dtype=torch.int64)
    T.uniform_torus(key, (40, 3, 9), out=out[..., :9])           # a strided view
    np.testing.assert_array_equal(out[..., :9].numpy(), one)
    assert not out[..., 9].any()
    bits = np.asarray(J.binary_key(J.key_from_seed(3), (40, 3, 9))).astype(np.int64)
    np.testing.assert_array_equal(T.binary_key(key, (40, 3, 9), rows=(38, 40)).numpy(),
                                  bits[38:40])


def test_bad_arguments_refused():
    key = T.key_from_seed(1, "cpu")
    with pytest.raises(ValueError):
        T.uniform_torus(key, ())
    with pytest.raises(ValueError):
        T.uniform_torus(key, (4, 2), rows=(3, 5))
    with pytest.raises(ValueError):
        T.uniform_torus(key, (4, 2), out=torch.empty((4, 3), dtype=torch.int64))
