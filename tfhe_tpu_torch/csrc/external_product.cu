// K7: the external product outside a blind rotation, with a GGSW per
// ciphertext.  For each row b of a batch of GLWE ciphertexts [R][N] u64:
//
//   out[b] = ct0[b] + GGSW[b] [x] op[b],   op[b] = ct1[b] - ct0[b]        (explicit)
//                                       or op[b] = X^e_b * ct0[b] - ct0[b] (rotated)
//
// where GGSW [x] op = sum_{l,r} decomp_l(op_r) * GGSW[l, r] mod (X^N + 1, 2^64)
// (decomp the balanced base-2^b digits, level-major: digit row j = l*R + r).
// The GGSW is given as the port's spectra [P][J][R][N] u32 (J = L*R), one
// per row `key_stride` words apart (0: one GGSW for the whole batch);
// ct0's and ct1's rows `*_stride` words apart (0: one shared row).
//
// Replaces the XLA external product of `external_product_accumulate`
// (tfhe_tpu/core/algorithms/bootstrap.py:50-77), which the JAX package's
// `cmux_ntt` (tfhe_tpu/core/algorithms/wopbs.py:190: the WoP-PBS's CMux
// tree and its GGSW-driven rotation in `vertical_packing`), `cmux` (:80)
// and `blind_rotate` (:89, `blind_rotate_only`) run; the TPU kernel's step
// body `_make_step_kernel_mxu` (tfhe_tpu/core/poly/pallas_ntt.py:601)
// computes the same product inside a rotation.  Unlike K4 (the delta step,
// csrc/rotation.cu), the operand is decomposed as a torus difference (the
// JAX functions' form, bit for bit) and each row may bring its own GGSW.
//
// Design, a simple one: a block of EP_THREADS threads owns one row.  For
// each prime p in turn it decomposes the operand straight into its J digit
// polynomials mod p in shared memory, transforms them in place
// (Cooley-Tukey with the psi twist merged into the twiddles, natural order
// in, bit-reversed out, one barrier a stage; `ntt.py`'s transform, so the
// spectra are in the order the key's are), multiplies and sums against
// the row's GGSW spectra into R products, transforms those back
// (Gentleman-Sande, times N^-1) and writes the residues to the scratch
// res[B][P][R][N] in device memory.  Then each thread lifts its
// coefficients over the P primes with Garner (signed lift, mod 2^64) and
// adds ct0.  The twiddles take Shoup's multiply (their 32-bit twins come
// with the table), the MAC a Barrett reduction with floor(2^64 / p).  Shared
// memory: (J + R) * N * 4 bytes (64 KB at the WoP-PBS's N = 2048, J = 6,
// R = 2).  The arithmetic is exact, so the result is bit-identical to the
// plain version (`core/poly/external_product.py`) and to the JAX function.
//
// Bound on the H100, at the WoP-PBS of WOPBS_PARAM_MESSAGE_2_CARRY_2_KS_PBS
// (N = 2048, k = 1, cbs 5 x 3, P = 3, batch 512): each row reads its own
// spectra, 3 * 6 * 2 * 2048 * 4 = 295 KB, so the key's bytes (151 MB, 0.045
// ms at 3.35 TB/s) bound it above its ~0.18 G modular multiplies.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int EP_THREADS = 256;
constexpr int EP_MAXP = 8;

// The constants buffer's layout (core/poly/rotation.py _host_consts).
constexpr int C_P = 0, C_BARRETT = 8, C_GINV = 16, C_GW = 32, C_HALF = 160, C_PREFIX = 168,
              C_MMOD = 176, C_NINV = 177, C_NINV_SH = 185;

struct EpArgs {
  const uint64_t* ct0;
  long long ct0_stride;
  const uint64_t* ct1;       // null: the rotated operand
  long long ct1_stride;
  const int* exps;           // rotated: e_b = exps[b * e_stride] in [0, 2N)
  long long e_stride;
  const uint32_t* ggsw;      // row b's spectra at ggsw + b * key_stride
  long long key_stride;
  const uint32_t* tab;       // [psi_rev, twin, psi_inv_rev, twin], each [P][N]
  const uint64_t* consts;    // the constants buffer
  uint32_t* res;             // scratch [B][P][R][N]
  uint64_t* out;             // [B][R][N]
  int n, log_n, P, R, L, base_log;
};

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  return a >= b ? a - b : a + p - b;
}

// x * w mod p for x < 2^32, with w_sh = floor(w * 2^32 / p).
__device__ __forceinline__ uint32_t mul_shoup(uint32_t x, uint32_t w, uint32_t w_sh,
                                              uint32_t p) {
  const uint32_t q = __umulhi(x, w_sh);
  const uint32_t r = x * w - q * p;
  return r >= p ? r - p : r;
}

// x mod p for any 64-bit x, with m = floor(2^64 / p): the quotient estimate
// is at most 1 below the true one.
__device__ __forceinline__ uint32_t reduce64(uint64_t x, uint32_t p, uint64_t m) {
  uint64_t r = x - __umul64hi(x, m) * p;
  if (r >= p) r -= p;
  if (r >= p) r -= p;
  return (uint32_t)r;
}

__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b, uint32_t p, uint64_t m) {
  return reduce64((uint64_t)a * b, p, m);
}

// Word (r, i) of the operand of row c0 / c1.
__device__ __forceinline__ uint64_t operand(const uint64_t* c0, const uint64_t* c1, int e,
                                            int r, int i, int n) {
  const uint64_t x = c0[(size_t)r * n + i];
  if (c1 != nullptr) return c1[(size_t)r * n + i] - x;
  // X^e * c0 at i: +-c0[(i - e) mod N], negated where the rotation wraps
  const bool flip = e >= n;
  const int rot = flip ? e - n : e;
  const uint64_t y = c0[(size_t)r * n + ((i - rot) & (n - 1))];
  return ((i < rot) != flip ? 0 - y : y) - x;
}

__global__ void __launch_bounds__(EP_THREADS)
    external_product_kernel(const __grid_constant__ EpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int n = a.n, log_n = a.log_n, P = a.P, R = a.R, L = a.L, J = L * R;
  const int half_n = n >> 1;
  uint32_t* spec = reinterpret_cast<uint32_t*>(smem);   // [J][N]
  uint32_t* prod = spec + (size_t)J * n;                 // [R][N]
  const uint64_t* c0 = a.ct0 + b * a.ct0_stride;
  const uint64_t* c1 = a.ct1 == nullptr ? nullptr : a.ct1 + b * a.ct1_stride;
  const int e = a.ct1 == nullptr ? a.exps[b * a.e_stride] : 0;
  const uint32_t* key = a.ggsw + b * a.key_stride;
  uint32_t* res = a.res + (size_t)b * P * R * n;
  const int base_log = a.base_log;
  const int shift = 64 - base_log * L;
  const uint64_t digit_mask = (1ull << base_log) - 1, half = 1ull << (base_log - 1);

  for (int pi = 0; pi < P; ++pi) {
    const uint32_t p = (uint32_t)a.consts[C_P + pi];
    const uint64_t m = a.consts[C_BARRETT + pi];
    // 1. the balanced digits of the operand, mod p, level-major rows
    for (int idx = threadIdx.x; idx < R * n; idx += blockDim.x) {
      const int r = idx >> log_n, i = idx & (n - 1);
      const uint64_t x = operand(c0, c1, e, r, i, n);
      uint64_t s = shift > 0 ? (x + (1ull << (shift - 1))) >> shift : x;
      for (int l = L - 1; l >= 0; --l) {   // the least significant digit first
        const uint64_t raw = s & digit_mask;
        const uint64_t carry = (raw + half) >> base_log;
        const int64_t d = (int64_t)raw - (int64_t)(carry << base_log);
        s = (s >> base_log) + carry;
        spec[(size_t)(l * R + r) * n + i] = d < 0 ? (uint32_t)(d + p) : (uint32_t)d;
      }
    }
    __syncthreads();
    // 2. forward transform of the J digit polynomials
    const uint32_t* w = a.tab + (size_t)pi * n;
    const uint32_t* w_sh = a.tab + (size_t)(P + pi) * n;
    for (int mm = 1, lt = log_n - 1; mm < n; mm <<= 1, --lt) {
      const int t = 1 << lt;
      for (int k = threadIdx.x; k < J * half_n; k += blockDim.x) {
        const int j = k >> (log_n - 1), q = k & (half_n - 1);
        const int grp = q >> lt, i0 = (grp << (lt + 1)) + (q & (t - 1)), i1 = i0 + t;
        uint32_t* v = spec + (size_t)j * n;
        const uint32_t u = v[i0];
        const uint32_t x = mul_shoup(v[i1], w[mm + grp], w_sh[mm + grp], p);
        v[i0] = add_mod(u, x, p);
        v[i1] = sub_mod(u, x, p);
      }
      __syncthreads();
    }
    // 3. the MAC with this row's GGSW: prod[r] = sum_j spec[j] * GGSW[p][j][r]
    const uint32_t* kp = key + (size_t)pi * J * R * n;
    for (int idx = threadIdx.x; idx < R * n; idx += blockDim.x) {
      const int r = idx >> log_n, k = idx & (n - 1);
      uint64_t acc = 0;
      for (int j = 0; j < J; ++j)
        acc += mul_mod(spec[(size_t)j * n + k], kp[((size_t)j * R + r) * n + k], p, m);
      prod[idx] = reduce64(acc, p, m);
    }
    __syncthreads();
    // 4. inverse transform of the R products, then times N^-1 into res
    const uint32_t* wi = a.tab + (size_t)(2 * P + pi) * n;
    const uint32_t* wi_sh = a.tab + (size_t)(3 * P + pi) * n;
    for (int h = half_n, lt = 0; h >= 1; h >>= 1, ++lt) {
      const int t = 1 << lt;
      for (int k = threadIdx.x; k < R * half_n; k += blockDim.x) {
        const int r = k >> (log_n - 1), q = k & (half_n - 1);
        const int grp = q >> lt, i0 = (grp << (lt + 1)) + (q & (t - 1)), i1 = i0 + t;
        uint32_t* v = prod + (size_t)r * n;
        const uint32_t u = v[i0], x = v[i1];
        v[i0] = add_mod(u, x, p);
        v[i1] = mul_shoup(sub_mod(u, x, p), wi[h + grp], wi_sh[h + grp], p);
      }
      __syncthreads();
    }
    const uint32_t ninv = (uint32_t)a.consts[C_NINV + pi];
    const uint32_t ninv_sh = (uint32_t)a.consts[C_NINV_SH + pi];
    for (int idx = threadIdx.x; idx < R * n; idx += blockDim.x) {
      const int r = idx >> log_n, i = idx & (n - 1);
      res[((size_t)pi * R + r) * n + i] = mul_shoup(prod[idx], ninv, ninv_sh, p);
    }
    __syncthreads();
  }
  // 5. Garner over the primes (signed lift, mod 2^64), plus ct0
  for (int idx = threadIdx.x; idx < R * n; idx += blockDim.x) {
    const int r = idx >> log_n, i = idx & (n - 1);
    uint32_t t[EP_MAXP];
    uint64_t c = 0;
    for (int k = 0; k < P; ++k) {
      const uint32_t pk = (uint32_t)a.consts[C_P + k];
      const uint64_t mk = a.consts[C_BARRETT + k];
      const uint32_t v = res[((size_t)k * R + r) * n + i];
      if (k == 0) {
        t[0] = v;
      } else {
        uint32_t acc = 0;
        for (int j = 0; j < k; ++j)
          acc = add_mod(acc, mul_mod(t[j], (uint32_t)a.consts[C_GW + 8 * k + j], pk, mk), pk);
        t[k] = mul_mod(sub_mod(v, acc, pk), (uint32_t)a.consts[C_GINV + k], pk, mk);
      }
      c += (uint64_t)t[k] * a.consts[C_PREFIX + k];
    }
    bool ge = false, eq = true;
    for (int k = P - 1; k >= 0; --k) {
      const uint64_t h = a.consts[C_HALF + k];
      ge = ge || (eq && t[k] > h);
      eq = eq && t[k] == h;
    }
    if (ge || eq) c -= a.consts[C_MMOD];
    a.out[(size_t)b * R * n + idx] = c0[idx] + c;
  }
}

}  // namespace

// K7.  ct0 [.][R][N] u64 rows ct0_stride words apart; ct1 likewise, or null
// for the rotated operand with exps int32 rows e_stride apart; ggsw u32
// spectra [P][J][R][N] a row, key_stride words apart; tab and consts as the
// rotation kernels take them (rotation.py _kernel_tables); res a scratch of
// B * P * R * N u32; out [B][R][N] u64, apart from every input.
extern "C" int tfhe_external_product(const void* ct0, long long ct0_stride, const void* ct1,
                                     long long ct1_stride, const void* exps, long long e_stride,
                                     const void* ggsw, long long key_stride, const void* tab,
                                     const void* consts, void* res, void* out, int batch, int n,
                                     int log_n, int P, int R, int L, int base_log,
                                     void* stream) {
  if (batch < 1 || n < 4 || n != (1 << log_n) || P < 1 || P > EP_MAXP || R < 1 || L < 1 ||
      base_log < 1 || base_log > 30 || base_log * L > 64 || (ct1 == nullptr && exps == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = (L * R + R) * n * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)external_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  EpArgs args = {(const uint64_t*)ct0, ct0_stride, (const uint64_t*)ct1, ct1_stride,
                 (const int*)exps, e_stride, (const uint32_t*)ggsw, key_stride,
                 (const uint32_t*)tab, (const uint64_t*)consts, (uint32_t*)res,
                 (uint64_t*)out, n, log_n, P, R, L, base_log};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch);
  cfg.blockDim = dim3(EP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.numAttrs = 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, external_product_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
