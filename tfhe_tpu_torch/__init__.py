"""tfhe_tpu_torch — the PyTorch and CUDA port of `tfhe_tpu`, for one NVIDIA
H100.

It runs the shortint keyswitch + PBS path end to end, with classic and
multi-bit keys: parameters, int64 torus numerics, generator-based
randomness, entities, the exact CRT-NTT, encryption and key generation,
keyswitch, the blind rotation on every route the JAX package's switches
select (`config.py`), the shortint op families, the radix, signed and
CRT integers on top of them, the high-level API (FheUint/FheInt/FheBool),
the casting key and the WoP-PBS, the boolean scheme, and the apps and
examples (Trivium/Kreyvium with transciphering, SHA-256, the dark market,
the regex engine).  Hand-written CUDA kernels carry the hot work (`csrc/`):
the whole blind rotation (K1 classic, K3 multi-bit), one rotation step per
launch (K4 delta, K5 paired or multi-bit), K6 beyond one block, the
keyswitch contraction (K2′, digits of 1 to 4 byte limbs), the external product with a GGSW a row
(K7), and a shared-memory probe.
Each sits beside a plain PyTorch version that CPU tensors take.

Layout mirrors `tfhe_tpu/`:
  config.py    the rotation switches (TFHE_TPU_MXU, _MXU_LANES, _FUSED)
  core/        params, numeric, rng, threefry, entities, decomposition,
               poly/ (ntt, rotation, external_product), algorithms/
               (encryption, keyswitch, bootstrap, multi_bit, public_key,
               seeded, linear, wopbs)
  shortint/    ciphertext, client_key, server_key, key_switching_key, wopbs
  integer/     ciphertext, client_key, server_key (radix, signed, CRT)
  hlapi/       the high-level API
  boolean/     the gates on both PBS orders
  apps/        trivium (booleans, shortint bits, bytes)
  examples/    sha256_bool, dark_market, regex_engine
  interop.py   keys and integer ciphertexts carried across from the JAX
               package (numpy arrays)
  cuda_lib.py  builds csrc/*.cu with nvcc at first use, loads with ctypes
  smem_probe.py  the largest dynamic shared memory a block gets

The package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"
