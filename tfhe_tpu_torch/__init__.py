"""tfhe_tpu_torch — the PyTorch and CUDA port of `tfhe_tpu`, for one NVIDIA
H100.

This first slice runs the shortint keyswitch + PBS main path end to end:
parameters, int64 torus numerics, generator-based randomness, entities,
the exact CRT-NTT, encryption and key generation, keyswitch, the delta-form
blind rotation and shortint lookup tables.  Two hand-written CUDA kernels
carry the hot work (`csrc/`): the whole blind rotation (replacing the JAX
package's Pallas `_make_rotation_kernel_mxu`) and the keyswitch contraction.
Each sits beside a plain PyTorch version that CPU tensors take.

Layout mirrors `tfhe_tpu/`:
  core/        params, numeric, rng, entities, decomposition,
               poly/ (ntt, rotation), algorithms/ (encryption, keyswitch,
               bootstrap)
  shortint/    ciphertext, client_key, server_key
  interop.py   keys carried across from the JAX package (numpy arrays)
  cuda_lib.py  builds csrc/*.cu with nvcc at first use, loads with ctypes

The package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"
