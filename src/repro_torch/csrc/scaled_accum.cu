// scaled_accum: out[n] = sum_c w[c] * x[c, n] * mask[n]  (FedFA M' and Gamma).
// x is f32 or bf16 (element-type code 0 or 2) and is upcast on load, as the
// TPU kernel upcasts its block; w, mask and out are f32.
//
// Replaces the TPU kernel repro/kernels/fedfa_agg/kernel.py::scaled_accum
// (_scaled_accum_kernel).  Bound on the H100: device-memory bytes -- the
// (m, n) cohort is read once (b = 4 or 2 bytes an element), mask read once,
// out written once: (m * b + 8) * n bytes at 3.35 TB/s; the m multiply-adds
// per column are far below the f32 rate.
//
// Design: a column-parallel reduction over the client axis.  Each thread
// owns columns (grid-stride), walks the m clients in registers and writes
// its column once; neighbouring threads read neighbouring addresses of each
// client row, four columns at a time (float4, or two bf16x2) when
// n % 4 == 0 and every pointer is aligned.  The ragged tail is masked in
// the loop bound: nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T>
__global__ void scaled_accum_vec4(const T* __restrict__ x,
                                  const float* __restrict__ w,
                                  const float4* __restrict__ mask,
                                  float4* __restrict__ out, int64_t m,
                                  int64_t n4) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int64_t c = 0; c < m; ++c) {
      const float4 v = load4(x + c * 4 * n4, i);
      const float wc = w[c];
      acc.x += wc * v.x;
      acc.y += wc * v.y;
      acc.z += wc * v.z;
      acc.w += wc * v.w;
    }
    const float4 mk = mask[i];
    out[i] = make_float4(acc.x * mk.x, acc.y * mk.y, acc.z * mk.z,
                         acc.w * mk.w);
  }
}

template <typename T>
__global__ void scaled_accum_scalar(const T* __restrict__ x,
                                    const float* __restrict__ w,
                                    const float* __restrict__ mask,
                                    float* __restrict__ out, int64_t m,
                                    int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
#pragma unroll 4
    for (int64_t c = 0; c < m; ++c) acc += w[c] * to_f32(x[c * n + i]);
    out[i] = acc * mask[i];
  }
}

template <typename T>
int launch(const T* x, const float* w, const float* mask, float* out,
           int64_t m, int64_t n, int sms, cudaStream_t s) {
  const int threads = 256;
  const bool vec = (n % 4 == 0) && ((uintptr_t)x % (4 * sizeof(T)) == 0) &&
                   ((uintptr_t)mask % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int64_t work = vec ? n / 4 : n;
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (vec)
    scaled_accum_vec4<T><<<(unsigned)blocks, threads, 0, s>>>(
        x, w, (const float4*)mask, (float4*)out, m, work);
  else
    scaled_accum_scalar<T><<<(unsigned)blocks, threads, 0, s>>>(x, w, mask,
                                                                out, m, n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 2 = bf16 (kernels/build.py DTYPE_CODES).
extern "C" int scaled_accum(const void* x, int dtype, const float* w,
                            const float* mask, float* out, int64_t m,
                            int64_t n, int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch((const float*)x, w, mask, out, m, n, sms, s);
  if (dtype == 2)
    return launch((const __nv_bfloat16*)x, w, mask, out, m, n, sms, s);
  return (int)cudaErrorInvalidValue;
}
