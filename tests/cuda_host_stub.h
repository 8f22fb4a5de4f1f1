// A host stand-in for the CUDA runtime and device intrinsics that
// tfhe_tpu_torch/csrc/rotation.cu and keyswitch.cu use, so that their kernels
// compile with a C++20 host compiler and run on the CPU: every CUDA thread of
// a block is a std::thread, __syncthreads() a std::barrier over the block,
// __syncwarp() one over the warp, and each block's dynamic shared memory a
// buffer of its own.  A cluster of C blocks (the launch's cluster dimension, 1
// without one) runs together, as C * blockDim.x threads: cluster.sync() is
// a std::barrier over all of them (and the barrier's halves, arrive and
// wait, are that barrier's) and map_shared_rank returns the same place in
// the peer block's buffer.  The blocks of a cluster start one after
// another, each once the one before it has reached the cluster barrier,
// in an order turned by one rank from cluster to cluster; a block's buffer
// is filled with stale data as it starts, so a write into a peer that has
// not started yet is lost, and scribbled over as soon as its last thread
// returns, as the card may give that memory to the next block.  Clusters
// run one after another, over grids of up to three dimensions (clusters
// along x).  The intrinsics compute what the device's do.  A warp's lanes
// exchange values through a mailbox of their own (two sets, used in turn,
// so one __syncwarp a call suffices): __shfl_xor_sync, and the warp-wide
// mma.sync m16n8k32 s8 x u8 -> s32 (`host_mma_s8u8`: each lane posts its
// fragments, __syncwarp, then each lane computes its own C fragment, in the
// PTX ISA's fragment layout, which CUTLASS encodes as
// SM80_16x8x32_S32S8U8S32_TN in cute/atom/mma_traits_sm80.hpp).  cp.async
// is a synchronous copy (`host_cp_async16`, zero-filling past its source
// size), so its commit and wait are no-ops.  tests/cuda_host.py builds the
// sources against it; it is no part of the port.
#pragma once
#include <atomic>
#include <array>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <new>
#include <optional>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __grid_constant__
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n)

struct uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline unsigned long long __umul64hi(unsigned long long a, unsigned long long b) {
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
}
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}

constexpr size_t HOST_SMEM = 232448;   // shared memory one block may use on sm_90

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline unsigned host_cluster_size = 1;
inline thread_local unsigned host_rank;               // this thread's block in its cluster
inline thread_local unsigned char* host_smem;         // this thread's block's shared memory
inline thread_local std::barrier<>* host_block_barrier;
inline thread_local std::barrier<>* host_warp_barriers;   // this block's, one per warp
inline std::unique_ptr<std::barrier<>> host_cluster_barrier;
inline std::vector<unsigned char*> host_cluster_smem;     // the cluster's blocks' buffers
inline std::unique_ptr<std::atomic<bool>[]> host_reached;  // a block reached the cluster barrier
inline thread_local std::optional<std::barrier<>::arrival_token> host_arrival;
// Lets the block after this thread's in the start order start.
inline void host_reach() {
  std::atomic<bool>& r = host_reached[host_rank];
  if (!r.load()) {
    r.store(true);
    r.notify_all();
  }
}
// The cluster barrier's halves (rotation.cu's cluster_arrive_relaxed and
// cluster_wait).
inline void host_cluster_arrive() {
  host_reach();
  host_arrival.emplace(host_cluster_barrier->arrive());
}
inline void host_cluster_wait() {
  host_cluster_barrier->wait(std::move(*host_arrival));
  host_arrival.reset();
}
inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
inline void __syncwarp() { host_warp_barriers[threadIdx.x >> 5].arrive_and_wait(); }

// A warp's mailbox: [2 sets][32 lanes][4 words of 64 bits]; each call that
// exchanges through it posts into the set of its turn, meets the warp at one
// __syncwarp, reads, and turns to the other set.  A lane may post into a set
// only after every lane has read it two calls back, which that barrier
// ensures.
inline thread_local uint64_t* host_warp_mail;          // this thread's warp's mailbox
inline thread_local unsigned host_mail_turn;
inline uint64_t* host_mail(unsigned lane) { return host_warp_mail + (host_mail_turn * 32 + lane) * 4; }

template <class T> T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) <= 8, "one mailbox word");
  const unsigned lane = threadIdx.x & 31;
  std::memcpy(host_mail(lane), &v, sizeof(T));
  __syncwarp();
  T r;
  std::memcpy(&r, host_mail(lane ^ (unsigned)lane_mask), sizeof(T));
  host_mail_turn ^= 1;
  return r;
}

// mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32, d += A * B.  Lane
// (g, t) = (lane / 4, lane % 4) holds A's rows g (a0, a2) and g + 8 (a1, a3),
// bytes k = 4t..4t+3 (a0, a1) and 16+4t..16+4t+3 (a2, a3), byte i of a word
// at k % 4 = i; B's column g, the same k (b0, b1); C's rows g (c0, c1) and
// g + 8 (c2, c3), columns 2t and 2t + 1.  Sums wrap mod 2^32.
inline void host_mma_s8u8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                          uint32_t b0, uint32_t b1) {
  const unsigned lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t mine[6] = {a0, a1, a2, a3, b0, b1};
  std::memcpy(host_mail(lane), mine, sizeof(mine));
  __syncwarp();
  for (unsigned c = 0; c < 4; ++c) {
    const unsigned row = g + 8 * (c >> 1), col = 2 * t + (c & 1);
    uint32_t sum = 0;
    for (unsigned k = 0; k < 32; ++k) {
      uint32_t a_word, b_word;
      std::memcpy(&a_word, reinterpret_cast<const uint32_t*>(
                               host_mail((row % 8) * 4 + (k % 16) / 4)) +
                               (row >= 8) + 2 * (k >= 16), 4);
      std::memcpy(&b_word, reinterpret_cast<const uint32_t*>(
                               host_mail(col * 4 + (k % 16) / 4)) + 4 + (k >= 16), 4);
      const int8_t a = (int8_t)(a_word >> (8 * (k % 4)));
      const uint8_t b = (uint8_t)(b_word >> (8 * (k % 4)));
      sum += (uint32_t)((int32_t)a * (int32_t)b);
    }
    d[c] = (int)((uint32_t)d[c] + sum);
  }
  host_mail_turn ^= 1;
}

// cp.async.cg.shared.global, 16 bytes of which `bytes` are read, the rest zero.
inline void host_cp_async16(void* dst, const void* src, int bytes) {
  std::memcpy(dst, src, bytes);
  std::memset(static_cast<unsigned char*>(dst) + bytes, 0, 16 - bytes);
}

inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaLaunchAttributeProgrammaticStreamSerialization, cudaLaunchAttributeClusterDimension,
  cudaDevAttrMultiProcessorCount, cudaFuncAttributeNonPortableClusterSizeAllowed
};
struct cudaLaunchAttributeValue {
  int programmaticStreamSerializationAllowed;
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute { int id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host stand-in"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return cudaSuccess; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t*) {
  *n = 1;
  return cudaSuccess;
}

// Runs the grid: cluster after cluster, each as C * blockDim.x threads (one
// std::thread per CUDA thread, started once for the whole grid and held
// between clusters by a barrier).
template <class... Params, class... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Params...),
                               Args&&... args) {
  unsigned C = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      C = cfg->attrs[i].val.clusterDim.x;
  if (cfg->dynamicSmemBytes > HOST_SMEM || C < 1 || cfg->gridDim.x % C != 0)
    return cudaErrorInvalidValue;
  const unsigned threads = cfg->blockDim.x, warps = (threads + 31) / 32;
  const unsigned row = cfg->gridDim.x / C;   // clusters along x
  const unsigned clusters = row * cfg->gridDim.y * cfg->gridDim.z;
  blockDim = dim3(threads);
  gridDim = cfg->gridDim;
  host_cluster_size = C;
  std::vector<std::unique_ptr<std::barrier<>>> blocks;
  std::vector<std::barrier<>*> warp_sets;
  for (unsigned c = 0; c < C; ++c) {
    blocks.push_back(std::make_unique<std::barrier<>>(threads));
    warp_sets.push_back(static_cast<std::barrier<>*>(
        ::operator new(sizeof(std::barrier<>) * warps)));
    for (unsigned w = 0; w < warps; ++w) new (&warp_sets[c][w]) std::barrier<>(32);
  }
  std::vector<unsigned char> memory(HOST_SMEM * C + 16);
  host_cluster_smem.clear();
  unsigned char* aligned = memory.data() + (16 - (uintptr_t)memory.data() % 16) % 16;
  for (unsigned c = 0; c < C; ++c) host_cluster_smem.push_back(aligned + HOST_SMEM * c);
  host_cluster_barrier = std::make_unique<std::barrier<>>(C * threads);
  host_reached.reset(new std::atomic<bool>[C]);
  // a block's shared memory is scribbled over as soon as its last thread
  // leaves the kernel, as the card may hand it to the next block: a peer
  // still reading it then reads garbage
  struct Scribble {
    unsigned char* p;
    void operator()() noexcept { std::memset(p, 0x5A, HOST_SMEM); }
  };
  std::vector<std::unique_ptr<std::barrier<Scribble>>> exits;
  for (unsigned c = 0; c < C; ++c)
    exits.push_back(std::make_unique<std::barrier<Scribble>>(threads,
                                                               Scribble{host_cluster_smem[c]}));
  std::barrier<> between_clusters(C * threads);
  std::vector<uint64_t> mail((size_t)C * warps * 2 * 32 * 4);
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < C * threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx = dim3(t % threads);
      host_rank = t / threads;
      host_smem = host_cluster_smem[host_rank];
      host_block_barrier = blocks[host_rank].get();
      host_warp_barriers = warp_sets[host_rank];
      host_warp_mail = mail.data() + ((size_t)host_rank * warps + threadIdx.x / 32) * 2 * 32 * 4;
      host_mail_turn = 0;
      for (unsigned b = 0; b < clusters; ++b) {
        blockIdx = dim3(b % row * C + host_rank, b / row % cfg->gridDim.y,
                        b / row / cfg->gridDim.y);
        if (t == 0)
          for (unsigned c = 0; c < C; ++c) host_reached[c].store(false);
        between_clusters.arrive_and_wait();
        // rank b % C starts first, each next rank once the one before has
        // reached the cluster barrier
        if (host_rank != b % C) host_reached[(host_rank + C - 1) % C].wait(false);
        if (threadIdx.x == 0) std::memset(host_smem, 0xA5, HOST_SMEM);   // stale data
        host_block_barrier->arrive_and_wait();
        kernel(args...);
        host_reach();   // a block that returns without reaching the barrier
        exits[host_rank]->arrive_and_wait();
        between_clusters.arrive_and_wait();
      }
    });
  for (auto& th : pool) th.join();
  for (unsigned c = 0; c < C; ++c) {
    for (unsigned w = 0; w < warps; ++w) warp_sets[c][w].~barrier();
    ::operator delete(warp_sets[c]);
  }
  return cudaSuccess;
}

namespace cooperative_groups {
struct host_cluster {
  unsigned block_rank() const { return host_rank; }
  void sync() const {
    host_reach();
    host_cluster_barrier->arrive_and_wait();
  }
  template <class T> T* map_shared_rank(T* p, unsigned r) const {
    return reinterpret_cast<T*>(host_cluster_smem[r] +
                                (reinterpret_cast<unsigned char*>(p) - host_smem));
  }
};
inline host_cluster this_cluster() { return {}; }
}  // namespace cooperative_groups
