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
//
// K8: K7's form on the 2^128 torus, the step of a 128-bit blind rotation.
//
//   acc[b] += GGSW [x] (X^e_b * acc[b] - acc[b])     (mod X^N + 1, 2^128)
//
// acc [B][R][N][2] u64 (limb 0 the high word, limb 1 the low), one GGSW
// [P][J][R][N] u32 of spectra for the batch (`key_stride` 0) or one a row.
// Replaces the XLA `external_product_accumulate128`
// (tfhe_tpu/core/algorithms/pbs128.py:244-261), which `blind_rotate128`
// (:264-289) runs once a step.  K7's kernel with WIDE set: the same block a
// row, transforms, MAC and Garner digits; three things differ:
//   * the operand is a 128-bit difference (a borrow between the limbs);
//   * the digits come from the high limb (`rounded_operand`);
//   * the lift is mod 2^128: sum_k t_k * (prod_{j<k} p_j mod 2^128), each a
//     64 x 128-bit product from __umul64hi, less M mod 2^128 where the lift
//     is negative (M, the product of 6 or 7 primes, exceeds 2^128; only its
//     residue is needed).  Both come after the 64-bit constants in the
//     buffer.
// Shared memory (J + R) * N * 4 bytes: 32 KB at 2_2's shapes on the 2^128
// torus (N = 2048, k = 1, PBS 23 x 1, so J = 2), P = 6.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int EP_THREADS = 256;
constexpr int EP_MAXP = 8;

// The constants buffer's layout (core/poly/rotation.py _host_consts, then
// _kernel_tables' 2^128 words: (hi, lo) of each prefix prod_{j<k} p_j mod
// 2^128, then of M mod 2^128).
constexpr int C_P = 0, C_BARRETT = 8, C_GINV = 16, C_GW = 32, C_HALF = 160, C_PREFIX = 168,
              C_MMOD = 176, C_NINV = 177, C_NINV_SH = 185, C_PREFIX128 = 193, C_MMOD128 = 209;

struct EpArgs {
  const uint64_t* ct0;       // K7 rows [R][N]; K8 acc rows [R][N][2]
  long long ct0_stride;
  const uint64_t* ct1;       // K7's explicit operand; null: the rotated operand
  long long ct1_stride;
  const int* exps;           // rotated: e_b = exps[b * e_stride] in [0, 2N)
  long long e_stride;
  const uint32_t* ggsw;      // row b's spectra at ggsw + b * key_stride
  long long key_stride;
  const uint32_t* tab;       // [psi_rev, twin, psi_inv_rev, twin], each [P][N]
  const uint64_t* consts;    // the constants buffer
  uint32_t* res;             // scratch [B][P][R][N]
  uint64_t* out;             // K7 [B][R][N]; K8 [B][R][N][2]
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

// Word (r, i) of X^e * row - row on the 2^128 torus, as (hi, lo).
__device__ __forceinline__ void operand128(const uint64_t* c0, int e, int r, int i, int n,
                                           uint64_t& hi, uint64_t& lo) {
  const uint64_t* row = c0 + (size_t)r * n * 2;
  const uint64_t xh = row[2 * i], xl = row[2 * i + 1];
  const bool flip = e >= n;
  const int rot = flip ? e - n : e;
  const int src = (i - rot) & (n - 1);
  uint64_t yh = row[2 * src], yl = row[2 * src + 1];
  if ((i < rot) != flip) {   // negated where the rotation wraps
    yh = ~yh + (yl == 0 ? 1ull : 0ull);
    yl = 0 - yl;
  }
  lo = yl - xl;
  hi = yh - xh - (yl < xl ? 1ull : 0ull);
}

// The operand word (r, i) rounded to its top base_log * L bits (shift = 64
// - base_log * L), the value its digits are taken from.  On the 2^128 torus
// they lie in the high limb: below 64 bits the rounding constant is in hi
// and nothing carries out of lo; at exactly 64, lo's top bit is the
// rounding bit (tfhe_tpu/core/decomposition.py:47 signed_decompose128).
template <bool WIDE>
__device__ __forceinline__ uint64_t rounded_operand(const uint64_t* c0, const uint64_t* c1,
                                                    int e, int r, int i, int n, int shift) {
  uint64_t hi, lo = 0;
  if constexpr (WIDE) {
    operand128(c0, e, r, i, n, hi, lo);
  } else {
    hi = operand(c0, c1, e, r, i, n);
  }
  return shift > 0 ? (hi + (1ull << (shift - 1))) >> shift : hi + (lo >> 63);
}

// K7 (WIDE false) and K8 (WIDE true): one block a row.
template <bool WIDE>
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
      uint64_t s = rounded_operand<WIDE>(c0, c1, e, r, i, n, shift);
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
  // 5. Garner over the primes, the signed lift (mod 2^64 or 2^128), plus ct0
  for (int idx = threadIdx.x; idx < R * n; idx += blockDim.x) {
    const int r = idx >> log_n, i = idx & (n - 1);
    uint32_t t[EP_MAXP];
    uint64_t c = 0, ch = 0;   // the lift; ch its high word on the 2^128 torus
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
      if constexpr (WIDE) {
        // t_k * prefix_k mod 2^128: a 64 x 128-bit product from __umul64hi
        const uint64_t ph = a.consts[C_PREFIX128 + 2 * k], pl = a.consts[C_PREFIX128 + 2 * k + 1];
        const uint64_t plo = (uint64_t)t[k] * pl;
        c += plo;
        ch += __umul64hi((uint64_t)t[k], pl) + (uint64_t)t[k] * ph + (c < plo ? 1ull : 0ull);
      } else {
        c += (uint64_t)t[k] * a.consts[C_PREFIX + k];
      }
    }
    bool ge = false, eq = true;   // the lift is negative: t >= (M - 1) / 2 digit-wise
    for (int k = P - 1; k >= 0; --k) {
      const uint64_t h = a.consts[C_HALF + k];
      ge = ge || (eq && t[k] > h);
      eq = eq && t[k] == h;
    }
    if constexpr (WIDE) {
      if (ge || eq) {
        const uint64_t mh = a.consts[C_MMOD128], ml = a.consts[C_MMOD128 + 1];
        ch -= mh + (c < ml ? 1ull : 0ull);
        c -= ml;
      }
      const uint64_t xh = c0[(size_t)2 * idx], xl = c0[(size_t)2 * idx + 1];
      const uint64_t lo = xl + c;
      uint64_t* o = a.out + ((size_t)b * R * n + idx) * 2;
      o[0] = xh + ch + (lo < xl ? 1ull : 0ull);
      o[1] = lo;
    } else {
      if (ge || eq) c -= a.consts[C_MMOD];
      a.out[(size_t)b * R * n + idx] = c0[idx] + c;
    }
  }
}

// Checks the launch, sets the shared memory and launches K7 or K8.
template <bool WIDE>
int launch(const EpArgs& args, int batch, int max_p, void* stream) {
  const int n = args.n, R = args.R, L = args.L, base_log = args.base_log;
  if (batch < 1 || n < 4 || n != (1 << args.log_n) || args.P < 1 || args.P > max_p || R < 1 ||
      L < 1 || base_log < 1 || base_log > 30 || base_log * L > 64 ||
      (args.ct1 == nullptr && args.exps == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = (L * R + R) * n * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute((const void*)external_product_kernel<WIDE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch);
  cfg.blockDim = dim3(EP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.numAttrs = 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, external_product_kernel<WIDE>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// K7.  ct0 [.][R][N] u64 rows ct0_stride words apart; ct1 likewise, or null
// for the rotated operand with exps int32 rows e_stride apart; ggsw u32
// spectra [P][J][R][N] a row, key_stride words apart; tab and consts as
// rotation.py _kernel_tables gives them; res a scratch of B * P * R * N
// u32; out [B][R][N] u64, apart from every input.
extern "C" int tfhe_external_product(const void* ct0, long long ct0_stride, const void* ct1,
                                     long long ct1_stride, const void* exps, long long e_stride,
                                     const void* ggsw, long long key_stride, const void* tab,
                                     const void* consts, void* res, void* out, int batch, int n,
                                     int log_n, int P, int R, int L, int base_log,
                                     void* stream) {
  const EpArgs args = {(const uint64_t*)ct0, ct0_stride, (const uint64_t*)ct1, ct1_stride,
                       (const int*)exps, e_stride, (const uint32_t*)ggsw, key_stride,
                       (const uint32_t*)tab, (const uint64_t*)consts, (uint32_t*)res,
                       (uint64_t*)out, n, log_n, P, R, L, base_log};
  return launch<false>(args, batch, EP_MAXP, stream);
}

// K8.  acc [.][R][N][2] u64 rows acc_stride words apart; exps int32 rows
// e_stride apart, each in [0, 2N); ggsw u32 spectra [P][J][R][N] a row,
// key_stride words apart (0: one GGSW for the batch); tab and consts as K7
// takes them (the 2^128 words included); res a scratch of B * P * R * N
// u32; out [B][R][N][2] u64, apart from every input.
extern "C" int tfhe_external_product128(const void* acc, long long acc_stride, const void* exps,
                                        long long e_stride, const void* ggsw,
                                        long long key_stride, const void* tab,
                                        const void* consts, void* res, void* out, int batch,
                                        int n, int log_n, int P, int R, int L, int base_log,
                                        void* stream) {
  const EpArgs args = {(const uint64_t*)acc, acc_stride, nullptr, 0, (const int*)exps,
                       e_stride, (const uint32_t*)ggsw, key_stride, (const uint32_t*)tab,
                       (const uint64_t*)consts, (uint32_t*)res, (uint64_t*)out,
                       n, log_n, P, R, L, base_log};
  return exps == nullptr ? (int)cudaErrorInvalidValue : launch<true>(args, batch, 7, stream);
}
