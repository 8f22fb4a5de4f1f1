// A host stand-in for the CUDA runtime and device intrinsics that
// tfhe_tpu_torch/csrc/rotation.cu uses, so that its kernels compile with a
// C++20 host compiler and run on the CPU: every CUDA thread of a block is a
// std::thread, __syncthreads() a std::barrier over the block, __syncwarp()
// one over the warp, and each block's dynamic shared memory a buffer of
// its own.  A cluster of C blocks (the launch's cluster dimension, 1
// without one) runs together, as C * blockDim.x threads: cluster.sync() is
// a std::barrier over all of them (and the barrier's halves, arrive and
// wait, are that barrier's) and map_shared_rank returns the same place in
// the peer block's buffer.  The blocks of a cluster start one after
// another, each once the one before it has reached the cluster barrier,
// in an order turned by one rank from cluster to cluster; a block's buffer
// is filled with stale data as it starts, so a write into a peer that has
// not started yet is lost, and scribbled over as soon as its last thread
// returns, as the card may give that memory to the next block.  Clusters
// run one after another.  The
// intrinsics compute what the device's do.  tests/test_torch_delta_host.py
// and tests/test_torch_staged_host.py build it; it is no part of the port.
#pragma once
#include <atomic>
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
inline dim3 blockDim;
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
  blockDim = dim3(threads);
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
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < C * threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx = dim3(t % threads);
      host_rank = t / threads;
      host_smem = host_cluster_smem[host_rank];
      host_block_barrier = blocks[host_rank].get();
      host_warp_barriers = warp_sets[host_rank];
      for (unsigned b = 0; b < cfg->gridDim.x / C; ++b) {
        blockIdx = dim3(b * C + host_rank);
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
