"""The port's key cache (`tfhe_tpu_torch.utils.KeyCache`) and secure seeding
(`secure_seed`): a name is generated once and then read from memory or from
its file, by another cache too; a file written by the JAX package's cache
loads in the port's and the reverse; a lock left by a dead process is
broken; seeds are in range and fresh."""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from tfhe_tpu.core.entities import LweCiphertext as JLwe
from tfhe_tpu.utils import KeyCache as JKeyCache
from tfhe_tpu_torch import boolean as B
from tfhe_tpu_torch.core.entities import LweCiphertext
from tfhe_tpu_torch.core.numeric import to_numpy_u64
from tfhe_tpu_torch.core.params import TEST_PARAMS_BOOLEAN
from tfhe_tpu_torch.utils import KeyCache, secure_seed


def test_generated_once_then_read(tmp_path):
    calls = []

    def make():
        calls.append(1)
        return B.gen_keys(TEST_PARAMS_BOOLEAN, seed=4, device="cpu")[1]
    cache = KeyCache(tmp_path / "c", device="cpu")
    sk = cache.get("bool", make)
    assert cache.get("bool", make) is sk and calls == [1]
    assert (tmp_path / "c" / "bool.npz").exists()
    assert not list((tmp_path / "c").glob("*.lock"))
    again = KeyCache(tmp_path / "c", device="cpu").get("bool", make)
    assert calls == [1]
    assert torch.equal(again.bsk.spectra, sk.bsk.spectra)
    assert torch.equal(again.ksk.data, sk.ksk.data) and again.params == sk.params
    cache.clear()
    assert not list((tmp_path / "c").glob("*.npz"))


def test_shared_with_the_jax_cache(tmp_path):
    words = np.array([[1, 2, 2 ** 63 + 5]], dtype=np.uint64)
    JKeyCache(tmp_path).get("jax_made", lambda: JLwe(data=jnp.asarray(words)))
    got = KeyCache(tmp_path, device="cpu").get("jax_made", lambda: None)
    np.testing.assert_array_equal(to_numpy_u64(got.data), words)
    port = LweCiphertext(data=torch.tensor([[7, -1, 3]]))
    KeyCache(tmp_path, device="cpu").get("port_made", lambda: port)
    back = JKeyCache(tmp_path).get("port_made", lambda: None)
    np.testing.assert_array_equal(np.asarray(back.data), to_numpy_u64(port.data))


def test_stale_lock_is_broken(tmp_path):
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    cache = KeyCache(tmp_path, device="cpu")
    (tmp_path / "x.lock").write_text(str(dead.pid))
    obj = cache.get("x", lambda: LweCiphertext(data=torch.zeros(1, 3, dtype=torch.int64)))
    assert obj.data.shape == (1, 3)
    assert not (tmp_path / "x.lock").exists() and (tmp_path / "x.npz").exists()
    assert not list(tmp_path.glob("*.stale.*"))


def test_secure_seed():
    seeds = {secure_seed() for _ in range(64)}
    assert len(seeds) > 60 and all(0 <= s < 2 ** 32 for s in seeds)
    assert all(0 <= secure_seed(7) < 128 for _ in range(64))
    assert secure_seed(128).bit_length() <= 128
