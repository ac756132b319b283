// trimmed_sumsq: out = sum_i w[i]^2 * [|w[i]| <= t] over a flat vector
// (the numerator of the trimmed norm of FedFA section 4.3).  w is f32 or
// bf16 (element-type code 0 or 2) and is upcast on load, as the TPU kernel
// upcasts its block; t and out are f32.
//
// Replaces the TPU kernel repro/kernels/fedfa_agg/kernel.py::trimmed_sumsq
// (_trimmed_sumsq_kernel).  Bound on the H100: device-memory bytes -- w
// read once, b * n bytes (b = 4 or 2) at 3.35 TB/s; three operations per
// element.
//
// Design: the TPU kernel carries one running sum across its sequential
// grid in scratch memory.  Blocks on the card run in no order, so the sum
// is two-stage and deterministic, with no float atomics: a grid-stride
// pass in which each block reduces its share into one partial (four
// elements a load -- float4, or two bf16x2 -- when w is aligned), then one
// block that sums the partials in a fixed order.  The vector is taken as
// it is; the TPU's 128-lane packing and zero padding are not needed.  t is
// read from device memory, so the caller never waits for it.
#include <cub/block/block_reduce.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
using Reduce = cub::BlockReduce<float, kThreads>;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 load4(const float* p, int64_t i4) {
  return reinterpret_cast<const float4*>(p)[i4];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int64_t i4) {
  const uint2 raw = reinterpret_cast<const uint2*>(p)[i4];
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float kept(float v, float t) {
  return fabsf(v) <= t ? v * v : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
partial_sums(const T* __restrict__ w, const float* __restrict__ t_ptr,
             float* __restrict__ partial, int64_t n, bool vec) {
  __shared__ typename Reduce::TempStorage tmp;
  const float t = *t_ptr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  int64_t tail = 0;
  float acc = 0.f;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = first; i < n4; i += stride) {
      const float4 v = load4(w, i);
      acc += kept(v.x, t) + kept(v.y, t) + kept(v.z, t) + kept(v.w, t);
    }
    tail = 4 * n4;
  }
  for (int64_t i = tail + first; i < n; i += stride)
    acc += kept(to_f32(w[i]), t);
  const float total = Reduce(tmp).Sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ partial, int blocks,
             float* __restrict__ out) {
  __shared__ typename Reduce::TempStorage tmp;
  float acc = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kThreads) acc += partial[i];
  const float total = Reduce(tmp).Sum(acc);
  if (threadIdx.x == 0) *out = total;
}

template <typename T>
cudaError_t launch_partials(const T* w, const float* t, float* partial,
                            int64_t n, int blocks, cudaStream_t s) {
  const bool vec = ((uintptr_t)w % (4 * sizeof(T)) == 0);
  partial_sums<T><<<(unsigned)blocks, kThreads, 0, s>>>(w, t, partial, n,
                                                        vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 2 = bf16 (kernels/build.py DTYPE_CODES); partial holds
// `blocks` floats of scratch; out is one float.
extern "C" int trimmed_sumsq(const void* w, int dtype, const float* t,
                             float* partial, float* out, int64_t n,
                             int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dtype == 0)
    e = launch_partials((const float*)w, t, partial, n, blocks, s);
  else if (dtype == 2)
    e = launch_partials((const __nv_bfloat16*)w, t, partial, n, blocks, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  sum_partials<<<1, kThreads, 0, s>>>(partial, blocks, out);
  return (int)cudaGetLastError();
}
