// The LWE keyswitch on the card: out[b, m] = -sum_k d[b, k] * ksk[k, m] mod 2^64,
// plus the input body at m = M - 1, where d are the balanced base-2^b digits
// of the input mask (k = i * L + l, level-major) and ksk the keyswitching key
// as u64 torus words [K, M], K = n_in * L.
//
// Replaces the XLA int8-limb dot of `_neg_digit_mac`
// (tfhe_tpu/core/algorithms/keyswitch.py:41) and its u64 form
// `_neg_digit_mac_chunked` (:24), which the JAX package runs outside Pallas,
// and the decomposition before them (tfhe_tpu/core/decomposition.py:19).
// One form for every base_log b up to 31 (all 240 named sets with a
// keyswitching key, the WoP-PBS's private functional keyswitches, the packing
// keyswitches), two kernels:
//   * `decompose_kernel<D>` (tfhe_keyswitch_decompose): the signed
//     decomposition as an elementwise pass, the mask [B, n_in] u64 in, each
//     digit's D signed byte limbs out, [B, D, Kp] int8 (Kp = K rounded up to
//     16 bytes, the tail zero): d = sum_i e_i 2^(8i), e_i in [-128, 127].
//     D = 1 for b <= 8 (the digit itself fits s8), else ceil((b + 1) / 8):
//     2 for b <= 15, 3 for b <= 23, 4 for b <= 31, so the top limb of a
//     digit in [-2^(b-1), 2^(b-1)) fits s8 too.
//   * `tensor_core_kernel<D>` (tfhe_keyswitch_tc), K2': the contraction on
//     the int8 tensor cores, in effect [B, D*Kp] s8 x [D*Kp, 8M] u8 ->
//     [B, 8M] s32, where column 8m + s of the key operand at digit limb i is
//     byte s - i of every word of output column m: slot s of a word sums
//     S_s = sum_i sum_k e_{i,k} * byte_{s-i}(ksk[k, m]), for s < 8 and
//     s >= i (slots past 7 vanish mod 2^64).  The key is in device memory
//     once, in its limb layout [M, 8, Kp] uint8 (byte j of word (k, m) at
//     [m, j, k], built once per key); each digit limb reads the same staged
//     key tile at slot s - i.  The epilogue recombines a word as
//     -sum_s (sext(S_s) << 8s) mod 2^64.  S_s is exact in int32 over a depth
//     of at most 2^31 / (255 * sum_i max|e_i|): 65793 rows at b = 8, 32896,
//     21931 and 16448 at D = 2, 3 and 4; the wrapper splits K
//     (`keyswitch._tc_plan`) so that no split is deeper, and the splits add
//     their words with u64 atomics.
//
// Bound on the H100.  The useful limb-pair products are 8D - D(D-1)/2 a word
// (8, 15, 21, 26), each 2 * B * K * M integer operations: at
// PARAM_MESSAGE_2_CARRY_2 (D = 1, B = 512, K = 10240, M = 743) 62.3e9, 0.031
// ms at the int8 tensor-core rate (4096 multiply-adds a clock an SM, 132 SMs
// at 1980 MHz); the key's 60.9 MB take 0.018 ms at 3.35 TB/s, about 2/3 of
// that.  At the WoP-PBS's private functional keyswitch (D = 2, B = 512,
// K = 4098, M = 4096) 0.120 ms.  So the tensor cores bound it at every shape
// the paths run.  The mma does 8D products a word, the D(D-1)/2 below the
// key's first byte slot on zeros.
//
// Design.  `mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32`: signed digit
// limbs times unsigned key bytes, no (byte - 128) offset and no data-sum
// correction as the JAX package needs, no .satfinite (the int32 sums never
// reach 2^31 and must be exact).  An 8-column n-tile of the mma is exactly
// one output word's 8 slots; they sit in a quad of threads, two columns
// each, so a word is recombined with two quad shuffles.  Digit limb i's B
// fragment of column g is key row g - i of the same word, zero where g < i:
// the limbs add into the same accumulators.  A block of 256 threads (8
// warps, 2 x 4, each 64 x 32) owns a 128-row x 128-column (16 words) tile
// and loops over its share of K in steps of 64 bytes, staging the D digit
// tiles and the key tile through a ring in shared memory (4 stages for
// D <= 2, 3 at D = 3, 2 at D = 4: 64, 96, 96 and 80 KB) with cp.async (16 B a
// thread, zero-filled past the batch, the columns and Kp).  A thread reads
// 16 contiguous bytes of a row for two mma steps: the same k permutation in
// the A and B fragments, which leaves the dot product unchanged and makes
// every fragment load one conflict-free 128-bit load.  The grid runs the
// batch tiles of a column tile next to each other, so the key is read from
// device memory about once and the other batch tiles hit L2.  Where the
// tiles do not fill the SMs evenly, or the depth passes the int32 limit, the
// wrapper splits K (`_tc_plan`) and the splits add their partial words into
// a zeroed output with atomicAdd on u64 (wrapping addition is associative:
// the result is bit-identical whatever the order).  mma.sync is the first
// step; wgmma with TMA is the way to the full int8 rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIGIT_LIMBS = 4;

// ---- the decomposition pass ------------------------------------------------

constexpr int DEC_THREADS = 256;

// One thread a 16-byte chunk of a row of digits, written with one aligned
// 16-byte store a digit limb: it decomposes every mask word with a digit in
// the chunk (a word's digits span a chunk boundary where 16 % L != 0, so
// neighbours decompose such a word twice) and keeps the digits that fall in
// it; zeros past K.  The rounding add (wrapping) and every shift are on u64,
// as tfhe_tpu/core/decomposition.py computes them; digit l of word i goes to
// column i * L + l (level-major: l = 0 is the most significant), its limb j
// to row j of the digit's [D, Kp] block.  A limb below the top is the
// digit's low byte read signed, and the rest (d - e) / 256 carries on.
template <int D>
__global__ void __launch_bounds__(DEC_THREADS)
decompose_kernel(const int64_t* __restrict__ mask, long long row_stride,
                 int8_t* __restrict__ digits, int B, int n_in, int Kp, int base_log,
                 int levels) {
  const int shift = 64 - base_log * levels, chunks = Kp / 16;
  const uint64_t low = (1ull << base_log) - 1, half = 1ull << (base_log - 1);
  const unsigned stride = gridDim.x * DEC_THREADS;
  for (unsigned c = blockIdx.x * DEC_THREADS + threadIdx.x; c < (unsigned)B * chunks;
       c += stride) {
    const unsigned b = c / chunks;
    const int k0 = (int)(c - b * chunks) * 16;
    uint64_t lo[D] = {}, hi[D] = {};   // limb j's bytes 0-7 and 8-15 of the chunk
    for (int i = k0 / levels; i < n_in && i * levels < k0 + 16; ++i) {
      uint64_t s = (uint64_t)mask[b * row_stride + i];
      if (shift > 0) s = (s + (1ull << (shift - 1))) >> shift;
      for (int l = levels - 1; l >= 0; --l) {
        const uint64_t raw = s & low, carry = (raw + half) >> base_log;
        const int pos = i * levels + l - k0;
        if constexpr (D == 1) {   // the digit fits s8: 32-bit arithmetic
          const uint64_t digit = (uint8_t)(int8_t)((int)raw - (int)(carry << base_log));
          if (pos >= 0 && pos < 8) lo[0] |= digit << (8 * pos);
          if (pos >= 8 && pos < 16) hi[0] |= digit << (8 * (pos - 8));
        } else {
          long long d = (long long)raw - (long long)(carry << base_log);
#pragma unroll
          for (int j = 0; j < D; ++j) {
            const int e = j + 1 < D ? (int)(int8_t)(uint8_t)(d & 0xff) : (int)d;
            d = (d - e) >> 8;
            const uint64_t byte = (uint8_t)e;
            if (pos >= 0 && pos < 8) lo[j] |= byte << (8 * pos);
            if (pos >= 8 && pos < 16) hi[j] |= byte << (8 * (pos - 8));
          }
        }
        s = (s >> base_log) + carry;
      }
    }
#pragma unroll
    for (int j = 0; j < D; ++j)
      *reinterpret_cast<uint4*>(digits + ((size_t)b * D + j) * Kp + k0) =
          make_uint4((unsigned)lo[j], (unsigned)(lo[j] >> 32), (unsigned)hi[j],
                     (unsigned)(hi[j] >> 32));
  }
}

// ---- K2', the contraction on the int8 tensor cores ------------------------

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64, TC_THREADS = 256;

// The ring a digit-limb count D stages: D digit tiles, then the key tile, 64
// bytes of K each; 4 stages for D <= 2, 3 at D = 3 and 2 at D = 4, so that
// two blocks fit an SM at every D.
template <int D>
struct Ring {
  static constexpr int STAGES = D <= 2 ? 4 : D == 3 ? 3 : 2;
  static constexpr int STAGE_BYTES = (D * TC_BM + TC_BN) * TC_BK;
  static constexpr int SMEM = STAGES * STAGE_BYTES;   // 64, 96, 96 and 80 KB
};

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

// Stage `step`'s 64-byte slice of K: 128 rows of each digit limb, then 128
// key-byte rows, 4 chunks of 16 B a row, rows 64 B apart.
template <int D>
__device__ __forceinline__ void load_stage(unsigned char* stage, const int8_t* digits,
                                           const uint8_t* limbs, int B, int cols, int Kp,
                                           int b0, int n0, int step) {
  constexpr int ROWS = D * TC_BM + TC_BN;
  constexpr int CHUNKS = ROWS * (TC_BK / 16) / TC_THREADS;   // 2 (D + 1) a thread
  static_assert(CHUNKS * TC_THREADS == ROWS * (TC_BK / 16), "whole chunks");
  const int k0 = step * TC_BK;
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    const int c = threadIdx.x + q * TC_THREADS, row = c >> 2, k = k0 + 16 * (c & 3);
    const bool key = row >= D * TC_BM;
    // (at D = 1 the digit rows are rows 0..127 of limb 0, as K2' had them)
    const int limb = D == 1 ? 0 : row / TC_BM, brow = D == 1 ? row : row % TC_BM;
    const int g = key ? n0 + row - D * TC_BM : b0 + brow;
    const bool ok = g < (key ? cols : B) && k < Kp;
    const void* src = key ? (const void*)(limbs + (ok ? (size_t)g * Kp + k : 0))
                          : (const void*)(digits + (ok ? ((size_t)g * D + limb) * Kp + k : 0));
    cp_async16(stage + row * TC_BK + 16 * (c & 3), src, ok ? 16 : 0);
  }
}

// Block (bt, nt, split) -> out rows [128 bt, +128), words [16 nt, +16), over
// K steps [split * steps_per_split, +steps_per_split).
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
tensor_core_kernel(const int8_t* __restrict__ digits, const uint8_t* __restrict__ limbs,
                   const int64_t* __restrict__ body, int64_t* __restrict__ out, int B, int M,
                   int Kp, int tiles_b, int tiles_n, int steps_per_split, int splits) {
  using R = Ring<D>;
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
  for (int s = 0; s < R::STAGES - 1; ++s) {
    if (s < steps)
      load_stage<D>(smem + s * R::STAGE_BYTES, digits, limbs, B, cols, Kp, b0, n0, s0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<R::STAGES - 2>();
    __syncthreads();   // stage `it` is in; every warp is done with stage it - 1
    const int next = it + R::STAGES - 1;
    if (next < steps)
      load_stage<D>(smem + (next % R::STAGES) * R::STAGE_BYTES, digits, limbs, B, cols, Kp, b0,
                    n0, s0 + next);
    cp_async_commit();
    const unsigned char* stage = smem + (it % R::STAGES) * R::STAGE_BYTES;
    const unsigned char* bs = stage + D * TC_BM * TC_BK;
    // one digit limb at a time (unrolled, the limbs' fragments spill; at
    // D = 1 this is K2' as it was, instruction for instruction).  Thread
    // (g, t) reads bytes [16t, 16t + 16) of its rows: the first mma takes
    // [16t, 16t + 8), the second [16t + 8, 16t + 16), in A and B alike;
    // digit limb e meets key byte slot g - e of the same word (none below
    // slot e)
#pragma unroll 1
    for (int e = 0; e < D; ++e) {
      const unsigned char* as = stage + e * TC_BM * TC_BK;
      uint4 bf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bf[j] = g >= e
                    ? *reinterpret_cast<const uint4*>(bs + (wn * 32 + j * 8 + g - e) * TC_BK + 16 * t)
                    : make_uint4(0u, 0u, 0u, 0u);
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
  }
  // Epilogue: c0, c1 (row g) and c2, c3 (row g + 8) are slots 2t and 2t + 1
  // of word (n0 + 32 wn + 8 j) / 8; the quad sums a word's 8 slots.
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

// Each kernel instantiated for D = 1..MAX_DIGIT_LIMBS, indexed by D - 1.
using DecomposeFn = void (*)(const int64_t*, long long, int8_t*, int, int, int, int, int);
using TensorCoreFn = void (*)(const int8_t*, const uint8_t*, const int64_t*, int64_t*, int, int,
                              int, int, int, int, int);
const DecomposeFn DECOMPOSE[MAX_DIGIT_LIMBS] = {decompose_kernel<1>, decompose_kernel<2>,
                                                    decompose_kernel<3>, decompose_kernel<4>};
const TensorCoreFn TENSOR_CORE[MAX_DIGIT_LIMBS] = {
    tensor_core_kernel<1>, tensor_core_kernel<2>, tensor_core_kernel<3>, tensor_core_kernel<4>};
constexpr int TC_SMEM[MAX_DIGIT_LIMBS] = {Ring<1>::SMEM, Ring<2>::SMEM, Ring<3>::SMEM,
                                          Ring<4>::SMEM};

// Whether `digit_limbs` signed bytes hold a balanced base-2^base_log digit.
bool limbs_hold(int base_log, int digit_limbs) {
  return digit_limbs >= 1 && digit_limbs <= MAX_DIGIT_LIMBS && base_log >= 1 &&
         base_log <= (digit_limbs == 1 ? 8 : 8 * digit_limbs - 1);
}

}  // namespace

// The decomposition pass.  mask [B, n_in] u64 rows `row_stride` words apart
// (a ciphertext's mask inside [B, n_in + 1]); digits [B, digit_limbs, Kp]
// int8.
extern "C" int tfhe_keyswitch_decompose(const void* mask, long long row_stride, void* digits,
                                        int B, int n_in, int Kp, int base_log, int levels,
                                        int digit_limbs, void* stream) {
  if (B < 1 || n_in < 1 || !limbs_hold(base_log, digit_limbs) || levels < 1 ||
      base_log * levels > 64 || row_stride < n_in || Kp % 16 != 0 ||
      (long long)n_in * levels > Kp || (long long)B * digit_limbs * Kp >= (1ll << 31) ||
      (uintptr_t)digits % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)B * (Kp / 16) + DEC_THREADS - 1) / DEC_THREADS);
  return launch(DECOMPOSE[digit_limbs - 1], dim3(blocks < 4096 ? blocks : 4096), DEC_THREADS, 0,
                stream, (const int64_t*)mask, row_stride, (int8_t*)digits, B, n_in, Kp, base_log,
                levels);
}

// K2'.  digits [B, digit_limbs, Kp] int8, limbs [M, 8, Kp] uint8 (16-byte
// aligned rows), body [B], out [B, M] (zeroed by the caller where
// splits > 1).  The caller keeps each split's depth inside the int32 limit.
extern "C" int tfhe_keyswitch_tc(const void* digits, const void* limbs, const void* body,
                                 void* out, int B, int M, int Kp, int digit_limbs,
                                 int steps_per_split, int splits, void* stream) {
  const int k_steps = (Kp + TC_BK - 1) / TC_BK;
  if (B < 1 || M < 1 || Kp < 16 || Kp % 16 != 0 || digit_limbs < 1 ||
      digit_limbs > MAX_DIGIT_LIMBS || (long long)B * digit_limbs * Kp >= (1ll << 31) ||
      steps_per_split < 1 || splits < 1 || (long long)steps_per_split * splits < k_steps ||
      (long long)steps_per_split * (splits - 1) >= k_steps ||
      (uintptr_t)digits % 16 != 0 || (uintptr_t)limbs % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_b = (B + TC_BM - 1) / TC_BM, tiles_n = (8 * M + TC_BN - 1) / TC_BN;
  const long long blocks = (long long)tiles_b * tiles_n * splits;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  return launch(TENSOR_CORE[digit_limbs - 1], dim3((unsigned)blocks), TC_THREADS,
                TC_SMEM[digit_limbs - 1], stream, (const int8_t*)digits, (const uint8_t*)limbs,
                (const int64_t*)body, (int64_t*)out, B, M, Kp, tiles_b, tiles_n,
                steps_per_split, splits);
}
