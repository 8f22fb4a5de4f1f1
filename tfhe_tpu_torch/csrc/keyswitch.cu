// The LWE keyswitch on the card: out[b, m] = -sum_k d[b, k] * ksk[k, m] mod 2^64,
// plus the input body at m = M - 1, where d are the balanced base-2^b digits
// of the input mask (k = i * L + l, level-major) and ksk the keyswitching key
// as u64 torus words [K, M], K = n_in * L.
//
// Replaces the XLA int8-limb dot of `_neg_digit_mac`
// (tfhe_tpu/core/algorithms/keyswitch.py:41), which the JAX package runs
// outside Pallas, and the decomposition before it
// (tfhe_tpu/core/decomposition.py:19).  Two forms, chosen from the shape by
// the wrapper (`core/algorithms/keyswitch.py`, `tensor_core_form`):
//
// The tensor-core form (base_log <= 8 and K * 2^(b-1) * 255 < 2^31: 228 of the
// 240 named sets with a keyswitching key), two kernels:
//   * `decompose_kernel` (tfhe_keyswitch_decompose): the signed decomposition
//     as an elementwise pass, the mask [B, n_in] u64 in, the digits
//     [B, Kp] int8 out (Kp = K rounded up to 16 bytes, the tail zero).  The
//     digits lie in [-2^(b-1), 2^(b-1) - 1], so they fit s8.
//   * `tensor_core_kernel` (tfhe_keyswitch_tc), K2': one GEMM on the int8
//     tensor cores, [B, Kp] s8 x [Kp, 8M] u8 -> [B, 8M] s32, where column
//     8m + l of the key operand is byte l of every word of output column m
//     (the key's limb layout [M, 8, Kp] uint8, built once per key).  Each
//     limb sum S_l = sum_k d * byte_l is exact in int32 (|S_l| <= K * 2^(b-1)
//     * 255 < 2^31), and the epilogue recombines a word as
//     -sum_l (sext(S_l) << 8l) mod 2^64.
//
// Bound on the H100.  The GEMM is 8 * 2 * B * K * M integer operations: at
// PARAM_MESSAGE_2_CARRY_2 (B = 512, K = 10240, M = 743) 62.3e9, 0.031 ms at
// the int8 tensor-core rate (4096 multiply-adds a clock an SM, 132 SMs at
// 1980 MHz); the key's 60.9 MB take 0.018 ms at 3.35 TB/s, about 2/3 of that.
// So the tensor cores bound it at every main-path shape (2_2, its GROUP_2
// and GROUP_3 sets, 3_3, 4_4).
//
// Design.  `mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32`: signed digits
// times unsigned key bytes, no (byte - 128) offset and no data-sum correction
// as the JAX package needs, no .satfinite (the int32 sums never reach 2^31 and
// must be exact).  An 8-column n-tile of the mma is exactly one output word's
// 8 limbs; they sit in a quad of threads, two columns each, so a word is
// recombined with two quad shuffles.  A block of 256 threads (8 warps, 2 x 4,
// each 64 x 32) owns a 128-row x 128-column (16 words) tile and loops over
// its share of K in steps of 64 bytes, staging the digit and key tiles
// through a 4-stage ring in shared memory with cp.async (16 B a thread,
// zero-filled past the batch, the columns and Kp).  A thread reads 16
// contiguous bytes of a row for two mma steps: the same k permutation in the
// A and B fragments, which leaves the dot product unchanged and makes every
// fragment load one conflict-free 128-bit load.  The grid runs the batch
// tiles of a column tile next to each other, so the key is read from device
// memory about once and the other batch tiles hit L2.  Where the tiles do
// not fill the SMs evenly, the wrapper splits K (`_tc_plan`) and the splits
// add their partial words into a zeroed output with atomicAdd on u64
// (wrapping addition is associative: the result is bit-identical whatever the
// order).  mma.sync is the first step; wgmma with TMA is the way to the full
// int8 rate.
//
// The wide form (base_log > 8: the COMPACT_PK sets with b = 17 and 25, the
// WoP-PBS 3_3 and 4_4 sets with b = 10 and 11), `keyswitch_mac_kernel`
// (tfhe_keyswitch_mac): int32 digits from the torch decomposition and exact
// 64-bit wrapping multiply-adds on the CUDA cores, as JAX's u64 form
// (`_neg_digit_mac_chunked`, keyswitch.py:24).  Each 256-thread block stages
// a 32 x 32 digit tile and a 32 x 64 key tile in shared memory and each
// thread keeps 2 x 4 accumulators; it is bound by 64-bit integer multiplies
// (about three 32-bit IMADs each), then by key bytes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---- the wide form ---------------------------------------------------------

constexpr int TB = 32, TM = 64, TK = 32, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
keyswitch_mac_kernel(const int32_t* __restrict__ d, const int64_t* __restrict__ ksk,
                     const int64_t* __restrict__ body, int64_t* __restrict__ out,
                     int B, int K, int M) {
  __shared__ int32_t ds[TK][TB + 1];
  __shared__ uint64_t ks[TK][TM];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b0 = blockIdx.y * TB, m0 = blockIdx.x * TM;
  uint64_t acc[2][4] = {};

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = threadIdx.x; i < TB * TK; i += THREADS) {
      const int bb = i / TK, kk = i % TK, gb = b0 + bb, gk = k0 + kk;
      ds[kk][bb] = (gb < B && gk < K) ? d[(size_t)gb * K + gk] : 0;
    }
    for (int i = threadIdx.x; i < TK * TM; i += THREADS) {
      const int kk = i / TM, mm = i % TM, gk = k0 + kk, gm = m0 + mm;
      ks[kk][mm] = (gk < K && gm < M) ? (uint64_t)ksk[(size_t)gk * M + gm] : 0ull;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      uint64_t kv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = ks[kk][tx + 16 * jj];
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const uint64_t dv = (uint64_t)(int64_t)ds[kk][ty + 16 * ii];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] += dv * kv[jj];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int gb = b0 + ty + 16 * ii;
    if (gb >= B) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int gm = m0 + tx + 16 * jj;
      if (gm >= M) continue;
      uint64_t v = 0ull - acc[ii][jj];
      if (gm == M - 1) v += (uint64_t)body[gb];
      out[(size_t)gb * M + gm] = (int64_t)v;
    }
  }
}

// ---- the decomposition pass ------------------------------------------------

constexpr int DEC_THREADS = 256;

// One thread a 16-byte chunk of a row of digits, written with one aligned
// 16-byte store: it decomposes every mask word with a digit in the chunk
// (a word's digits span a chunk boundary where 16 % L != 0, so neighbours
// decompose such a word twice) and keeps the digits that fall in it; zeros
// past K.  The rounding add (wrapping) and every shift are on u64, as
// tfhe_tpu/core/decomposition.py computes them; digit l of word i goes to
// column i * L + l (level-major: l = 0 is the most significant).
__global__ void __launch_bounds__(DEC_THREADS)
decompose_kernel(const int64_t* __restrict__ mask, long long row_stride,
                 int8_t* __restrict__ digits, int B, int n_in, int Kp, int base_log,
                 int levels) {
  const int K = n_in * levels, shift = 64 - base_log * levels, chunks = Kp / 16;
  const uint64_t low = (1ull << base_log) - 1, half = 1ull << (base_log - 1);
  const unsigned stride = gridDim.x * DEC_THREADS;
  for (unsigned c = blockIdx.x * DEC_THREADS + threadIdx.x; c < (unsigned)B * chunks;
       c += stride) {
    const unsigned b = c / chunks;
    const int k0 = (int)(c - b * chunks) * 16;
    uint64_t lo = 0ull, hi = 0ull;   // the chunk's bytes 0-7 and 8-15
    for (int i = k0 / levels; i < n_in && i * levels < k0 + 16; ++i) {
      uint64_t s = (uint64_t)mask[b * row_stride + i];
      if (shift > 0) s = (s + (1ull << (shift - 1))) >> shift;
      for (int l = levels - 1; l >= 0; --l) {
        const uint64_t raw = s & low, carry = (raw + half) >> base_log;
        const uint64_t digit = (uint8_t)(int8_t)((int)raw - (int)(carry << base_log));
        const int pos = i * levels + l - k0;
        if (pos >= 0 && pos < 8) lo |= digit << (8 * pos);
        if (pos >= 8 && pos < 16) hi |= digit << (8 * (pos - 8));
        s = (s >> base_log) + carry;
      }
    }
    *reinterpret_cast<uint4*>(digits + (size_t)b * Kp + k0) =
        make_uint4((unsigned)lo, (unsigned)(lo >> 32), (unsigned)hi, (unsigned)(hi >> 32));
  }
}

// ---- K2', the contraction on the int8 tensor cores ------------------------

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64, TC_STAGES = 4, TC_THREADS = 256;
constexpr int TC_STAGE_BYTES = (TC_BM + TC_BN) * TC_BK;   // 16 KB: digits, then key bytes
constexpr int TC_SMEM = TC_STAGES * TC_STAGE_BYTES;       // 64 KB

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"((unsigned)__cvta_generic_to_shared(smem_dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// d += A (16 x 32 s8, row) * B (32 x 8 u8, col), s32, wrapping.
__device__ __forceinline__ void mma_s8u8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};" : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]) : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage `step`'s 64-byte slice of K: 128 digit rows, then 128 key-byte rows,
// 4 chunks of 16 B a row, rows 64 B apart.
__device__ __forceinline__ void load_stage(unsigned char* stage, const int8_t* digits,
                                           const uint8_t* limbs, int B, int cols, int Kp,
                                           int b0, int n0, int step) {
  constexpr int CHUNKS = (TC_BM + TC_BN) * (TC_BK / 16) / TC_THREADS;   // 4 a thread
  static_assert(CHUNKS * TC_THREADS == (TC_BM + TC_BN) * (TC_BK / 16), "whole chunks");
  const int k0 = step * TC_BK;
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    const int c = threadIdx.x + q * TC_THREADS, row = c >> 2, k = k0 + 16 * (c & 3);
    const bool key = row >= TC_BM;
    const int g = key ? n0 + row - TC_BM : b0 + row;
    const bool ok = g < (key ? cols : B) && k < Kp;
    const void* src = key ? (const void*)(limbs + (ok ? (size_t)g * Kp + k : 0))
                          : (const void*)(digits + (ok ? (size_t)g * Kp + k : 0));
    cp_async16(stage + row * TC_BK + 16 * (c & 3), src, ok ? 16 : 0);
  }
}

// Block (bt, nt, split) -> out rows [128 bt, +128), words [16 nt, +16), over
// K steps [split * steps_per_split, +steps_per_split).
__global__ void __launch_bounds__(TC_THREADS, 2)
tensor_core_kernel(const int8_t* __restrict__ digits, const uint8_t* __restrict__ limbs,
                   const int64_t* __restrict__ body, int64_t* __restrict__ out, int B, int M,
                   int Kp, int tiles_b, int tiles_n, int steps_per_split, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bt = blockIdx.x % tiles_b, rest = blockIdx.x / tiles_b;
  const int nt = rest % tiles_n, split = rest / tiles_n;
  const int b0 = bt * TC_BM, n0 = nt * TC_BN, cols = 8 * M;
  const int k_steps = (Kp + TC_BK - 1) / TC_BK;
  const int s0 = split * steps_per_split;
  const int steps = min(k_steps, s0 + steps_per_split) - s0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;             // the mma's group and thread in group
  const int wm = warp >> 2, wn = warp & 3;           // the warp's 64 rows, 32 columns

  int acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < steps)
      load_stage(smem + s * TC_STAGE_BYTES, digits, limbs, B, cols, Kp, b0, n0, s0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();   // stage `it` is in; every warp is done with stage it - 1
    const int next = it + TC_STAGES - 1;
    if (next < steps)
      load_stage(smem + (next % TC_STAGES) * TC_STAGE_BYTES, digits, limbs, B, cols, Kp, b0,
                 n0, s0 + next);
    cp_async_commit();
    const unsigned char* as = smem + (it % TC_STAGES) * TC_STAGE_BYTES;
    const unsigned char* bs = as + TC_BM * TC_BK;
    // thread (g, t) reads bytes [16t, 16t + 16) of its rows: the first mma
    // takes [16t, 16t + 8), the second [16t + 8, 16t + 16), in A and B alike
    uint4 bf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bf[j] = *reinterpret_cast<const uint4*>(bs + (wn * 32 + j * 8 + g) * TC_BK + 16 * t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm * 64 + i * 16 + g;
      const uint4 lo = *reinterpret_cast<const uint4*>(as + r * TC_BK + 16 * t);
      const uint4 hi = *reinterpret_cast<const uint4*>(as + (r + 8) * TC_BK + 16 * t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_s8u8(acc[i][j], lo.x, hi.x, lo.y, hi.y, bf[j].x, bf[j].y);
        mma_s8u8(acc[i][j], lo.z, hi.z, lo.w, hi.w, bf[j].z, bf[j].w);
      }
    }
  }
  // Epilogue: c0, c1 (row g) and c2, c3 (row g + 8) are limbs 2t and 2t + 1
  // of word (n0 + 32 wn + 8 j) / 8; the quad sums a word's 8 limbs.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = b0 + wm * 64 + i * 16 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint64_t v = ((uint64_t)(int64_t)acc[i][j][2 * h] << (16 * t)) +
                     ((uint64_t)(int64_t)acc[i][j][2 * h + 1] << (16 * t + 8));
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int m = (n0 + wn * 32 + j * 8) >> 3;
        if (t != j || row >= B || m >= M) continue;
        uint64_t w = 0ull - v;
        if (m == M - 1 && split == 0) w += (uint64_t)body[row];
        int64_t* dst = out + (size_t)row * M + m;
        if (splits == 1)
          *dst = (int64_t)w;
        else
          atomicAdd(reinterpret_cast<unsigned long long*>(dst), (unsigned long long)w);
      }
    }
  }
}

template <class... Params, class... Args>
int launch(void (*kernel)(Params...), dim3 grid, int threads, int smem, void* stream,
           Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.numAttrs = 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The wide form.  digits [B, K] int32, ksk [K, M] u64, body [B], out [B, M].
extern "C" int tfhe_keyswitch_mac(const void* digits, const void* ksk,
                                  const void* body, void* out, int B, int K, int M,
                                  void* stream) {
  if (B < 1 || K < 1 || M < 1) return (int)cudaErrorInvalidValue;
  return launch(keyswitch_mac_kernel, dim3((M + TM - 1) / TM, (B + TB - 1) / TB), THREADS, 0,
                stream, (const int32_t*)digits, (const int64_t*)ksk, (const int64_t*)body,
                (int64_t*)out, B, K, M);
}

// The decomposition pass.  mask [B, n_in] u64 rows `row_stride` words apart
// (a ciphertext's mask inside [B, n_in + 1]); digits [B, Kp] int8.
extern "C" int tfhe_keyswitch_decompose(const void* mask, long long row_stride, void* digits,
                                        int B, int n_in, int Kp, int base_log, int levels,
                                        void* stream) {
  if (B < 1 || n_in < 1 || base_log < 1 || base_log > 8 || levels < 1 ||
      base_log * levels > 64 || row_stride < n_in || Kp % 16 != 0 ||
      (long long)n_in * levels > Kp || (long long)B * Kp >= (1ll << 31) ||
      (uintptr_t)digits % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)B * (Kp / 16) + DEC_THREADS - 1) / DEC_THREADS);
  return launch(decompose_kernel, dim3(blocks < 4096 ? blocks : 4096), DEC_THREADS, 0, stream,
                (const int64_t*)mask, row_stride, (int8_t*)digits, B, n_in, Kp, base_log, levels);
}

// K2'.  digits [B, Kp] int8, limbs [M, 8, Kp] uint8 (16-byte aligned rows),
// body [B], out [B, M] (zeroed by the caller where splits > 1).
extern "C" int tfhe_keyswitch_tc(const void* digits, const void* limbs, const void* body,
                                 void* out, int B, int M, int Kp, int steps_per_split,
                                 int splits, void* stream) {
  const int k_steps = (Kp + TC_BK - 1) / TC_BK;
  if (B < 1 || M < 1 || Kp < 16 || Kp % 16 != 0 || steps_per_split < 1 || splits < 1 ||
      (long long)steps_per_split * splits < k_steps ||
      (long long)steps_per_split * (splits - 1) >= k_steps ||
      (uintptr_t)digits % 16 != 0 || (uintptr_t)limbs % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_b = (B + TC_BM - 1) / TC_BM, tiles_n = (8 * M + TC_BN - 1) / TC_BN;
  const long long blocks = (long long)tiles_b * tiles_n * splits;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  return launch(tensor_core_kernel, dim3((unsigned)blocks), TC_THREADS, TC_SMEM, stream,
                (const int8_t*)digits, (const uint8_t*)limbs, (const int64_t*)body,
                (int64_t*)out, B, M, Kp, tiles_b, tiles_n, steps_per_split, splits);
}
