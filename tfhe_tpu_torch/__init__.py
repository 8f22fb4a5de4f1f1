"""tfhe_tpu_torch — the PyTorch and CUDA port of `tfhe_tpu`, for one NVIDIA
H100.

It runs the shortint keyswitch + PBS path end to end, with classic and
multi-bit keys: parameters, int64 torus numerics, generator-based
randomness, entities, the exact CRT-NTT, encryption and key generation,
keyswitch, the blind rotation on every route the JAX package's switches
select (`config.py`), the shortint op families, the radix, signed and
CRT integers on top of them, the high-level API (FheUint/FheInt/FheBool),
the casting key and the WoP-PBS, the boolean scheme on the 64-bit torus and
the reference's 32-bit one (held lifted), the gadget fork, the 128-bit PBS,
the apps and examples (Trivium/Kreyvium with transciphering, SHA-256, the
dark market, the regex engine), the dp device mesh, the file format with
its key cache, the AES-CTR CSPRNG and the C API.  Hand-written CUDA kernels carry the hot work (`csrc/`):
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
  boolean/     the gates on both PBS orders, 64- and 32-bit tori
  gadget/      the odd-modulus gadget fork
  apps/        trivium (booleans, shortint bits, bytes)
  examples/    sha256_bool, dark_market, regex_engine
  parallel/    the dp mesh: a batch split across devices, one process
  utils/       serialization (tfhe_tpu-v1 files), KeyCache, secure_seed
  native/      the AES-CTR CSPRNG and the C ABI (g++ at first use, into build/)
  capi.py      the flat handle surface the C ABI dispatches to
  interop.py   keys and integer ciphertexts carried across from the JAX
               package (numpy arrays)
  cuda_lib.py  builds csrc/*.cu with nvcc at first use, loads with ctypes
  smem_probe.py  the largest dynamic shared memory a block gets

The package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"
