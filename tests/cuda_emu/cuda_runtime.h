// A stand-in for the CUDA runtime header that lets g++ build a kernel source
// for the CPU: one std::thread per CUDA thread, std::barrier for
// __syncthreads and for each warp's shuffles, the blocks of a cluster run
// together, blocks and clusters one after another (see emu.cpp). It covers
// what csrc/convnext_block.cu uses and nothing more. Shared memory is filled
// with NaN before every cluster, so a read of a value nobody wrote shows.
#pragma once
#include <cmath>
#include <cstddef>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern thread_local dim3 threadIdx, blockIdx;
template <class T> inline T __ldg(const T* p) { return *p; }
void __syncthreads();
float __shfl_xor_sync(unsigned mask, float v, int lane_mask);
float4* emu_smem();  // this block's dynamic shared memory
#define SLOWTV_DYNAMIC_SMEM(name) float4* name = emu_smem()

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
