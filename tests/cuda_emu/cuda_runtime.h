// A stand-in for the CUDA runtime header that lets g++ build a kernel source
// for the CPU: one std::thread per CUDA thread, std::barrier for
// __syncthreads and for each warp's shuffles, the blocks of a cluster run
// together, blocks and clusters one after another (see emu.cpp). It covers
// what the csrc/ sources built by the tests/test_torch_*_emu.py files use
// and nothing more. Shared memory is filled with NaN before every cluster,
// so a read of a value nobody wrote shows.
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
// Integer min and max, and a float's bits (csrc/warp.cu).
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
// Float arithmetic of csrc/photo*.cu: IEEE round-to-nearest (build with
// -ffp-contract=off so that g++ fuses none of them into an FMA), and the
// card's approximate division, exact here.
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fdividef(float a, float b) { return a / b; }  // approximate on the card
void __syncthreads();
float __shfl_xor_sync(unsigned mask, float v, int lane_mask);
double __shfl_xor_sync(unsigned mask, double v, int lane_mask);
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
// One cluster of any size at a time, as this emulation runs them.
template <class F>
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, F, const cudaLaunchConfig_t*) {
  *n = 1;
  return cudaSuccess;
}
// As on an H100: asking for more dynamic shared memory than a block may have
// (227 KB) is refused.
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int attr, int value) {
  return attr == cudaFuncAttributeMaxDynamicSharedMemorySize && value > 232448
             ? cudaErrorInvalidValue
             : cudaSuccess;
}
