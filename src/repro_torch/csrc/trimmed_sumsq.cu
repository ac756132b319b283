// trimmed_sumsq: out = sum_i w[i]^2 * [|w[i]| <= t] over a flat f32 vector
// (the numerator of the trimmed norm of FedFA section 4.3).
//
// Replaces the TPU kernel repro/kernels/fedfa_agg/kernel.py::trimmed_sumsq
// (_trimmed_sumsq_kernel).  Bound on the H100: device-memory bytes -- w
// read once, 4 * n bytes at 3.35 TB/s; three operations per element.
//
// Design: the TPU kernel carries one running sum across its sequential
// grid in scratch memory.  Blocks on the card run in no order, so the sum
// is two-stage and deterministic, with no float atomics: a grid-stride
// pass in which each block reduces its share into one partial (float4
// loads when w is 16-byte aligned), then one block that sums the partials
// in a fixed order.  The vector is taken as it is; the TPU's 128-lane
// packing and zero padding are not needed.  t is read from device memory,
// so the caller never waits for it.
#include <cub/block/block_reduce.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
using Reduce = cub::BlockReduce<float, kThreads>;

__device__ __forceinline__ float kept(float v, float t) {
  return fabsf(v) <= t ? v * v : 0.f;
}

__global__ void __launch_bounds__(kThreads)
partial_sums(const float* __restrict__ w, const float* __restrict__ t_ptr,
             float* __restrict__ partial, int64_t n, bool vec) {
  __shared__ typename Reduce::TempStorage tmp;
  const float t = *t_ptr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  int64_t tail = 0;
  float acc = 0.f;
  if (vec) {
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const int64_t n4 = n / 4;
    for (int64_t i = first; i < n4; i += stride) {
      const float4 v = w4[i];
      acc += kept(v.x, t) + kept(v.y, t) + kept(v.z, t) + kept(v.w, t);
    }
    tail = 4 * n4;
  }
  for (int64_t i = tail + first; i < n; i += stride) acc += kept(w[i], t);
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

}  // namespace

// partial holds `blocks` floats of scratch; out is one float.
extern "C" int trimmed_sumsq(const float* w, const float* t, float* partial,
                             float* out, int64_t n, int blocks,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = ((uintptr_t)w % 16 == 0);
  partial_sums<<<(unsigned)blocks, kThreads, 0, s>>>(w, t, partial, n, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials<<<1, kThreads, 0, s>>>(partial, blocks, out);
  return (int)cudaGetLastError();
}
