// The CPU emulation's runtime: build with
//   g++ -std=c++20 -O1 -shared -fPIC -pthread -I tests/cuda_emu \
//       -DKERNEL_SOURCE='"path/to/kernel.cu"' tests/cuda_emu/emu.cpp -o libemu.so
// and call the kernel source's extern "C" entry points on host pointers.
#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <barrier>
#include <memory>
#include <thread>
#include <vector>

thread_local dim3 threadIdx, blockIdx;
namespace {
thread_local unsigned tl_rank;  // this thread's block within its cluster
unsigned g_cluster = 1;
std::vector<std::unique_ptr<std::barrier<>>> g_block_barrier, g_warp_barrier;
std::unique_ptr<std::barrier<>> g_cluster_barrier;
std::vector<std::vector<double>> g_shuffle;     // per block, one slot per thread
std::vector<std::vector<float4>> g_smem;        // per block
}  // namespace

void __syncthreads() { g_block_barrier[tl_rank]->arrive_and_wait(); }
double __shfl_xor_sync(unsigned, double v, int lane_mask) {
  const unsigned t = threadIdx.x, warps = g_warp_barrier.size() / g_cluster;
  std::barrier<>& warp = *g_warp_barrier[tl_rank * warps + t / 32];
  g_shuffle[tl_rank][t] = v;
  warp.arrive_and_wait();
  const double r = g_shuffle[tl_rank][t ^ lane_mask];
  warp.arrive_and_wait();
  return r;
}
float __shfl_xor_sync(unsigned mask, float v, int lane_mask) {
  return (float)__shfl_xor_sync(mask, (double)v, lane_mask);  // exact: a float fits a double
}
float4* emu_smem() { return g_smem[tl_rank].data(); }
unsigned emu_cluster_rank() { return tl_rank; }
unsigned emu_cluster_size() { return g_cluster; }
void emu_cluster_sync() { g_cluster_barrier->arrive_and_wait(); }
void* emu_map_rank(void* p, unsigned rank) {
  char* mine = reinterpret_cast<char*>(g_smem[tl_rank].data());
  return reinterpret_cast<char*>(g_smem[rank].data()) + (static_cast<char*>(p) - mine);
}

template <class K, class... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, K kernel, Args... args) {
  g_cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i) {
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      g_cluster = cfg->attrs[i].val.clusterDim.x;
    }
  }
  const unsigned threads = cfg->blockDim.x, warps = (threads + 31) / 32;
  if (cfg->gridDim.x % g_cluster || threads % 32) return cudaErrorInvalidValue;
  g_smem.assign(g_cluster, std::vector<float4>(cfg->dynamicSmemBytes / sizeof(float4) + 1));
  g_shuffle.assign(g_cluster, std::vector<double>(threads));
  g_block_barrier.clear();
  g_warp_barrier.clear();
  for (unsigned b = 0; b < g_cluster; ++b) {
    g_block_barrier.emplace_back(new std::barrier<>(threads));
    for (unsigned w = 0; w < warps; ++w) g_warp_barrier.emplace_back(new std::barrier<>(32));
  }
  g_cluster_barrier.reset(new std::barrier<>(g_cluster * threads));
  // One std::thread per CUDA thread of a cluster, made once per launch: the
  // clusters run one after another, shared memory refilled with NaN between
  // them, and a copy a thread never waited for does not carry over.
  auto fill = []() noexcept {
    for (auto& block : g_smem) {
      for (auto& v : block) v = float4{NAN, NAN, NAN, NAN};
    }
  };
  std::barrier<decltype(fill)> between(g_cluster * threads, fill);
  fill();
  std::vector<std::thread> pool;
  for (unsigned rank = 0; rank < g_cluster; ++rank) {
    for (unsigned t = 0; t < threads; ++t) {
      pool.emplace_back([=, &between] {
        threadIdx = dim3(t);
        tl_rank = rank;
        for (unsigned first = 0; first < cfg->gridDim.x; first += g_cluster) {
          blockIdx = dim3(first + rank);
          emu_copy_batches.clear();
          emu_copy_open.clear();
          kernel(args...);
          between.arrive_and_wait();
        }
      });
    }
  }
  for (auto& th : pool) th.join();
  return cudaSuccess;
}

#include KERNEL_SOURCE
