// scaled_accum: out[n] = sum_c w[c] * x[c, n] * mask[n]  (FedFA M' and Gamma).
//
// Replaces the TPU kernel repro/kernels/fedfa_agg/kernel.py::scaled_accum
// (_scaled_accum_kernel).  Bound on the H100: device-memory bytes -- the
// (m, n) f32 cohort is read once, mask read once, out written once:
// (m + 2) * n * 4 bytes at 3.35 TB/s; the m multiply-adds per column are
// far below the f32 rate.
//
// Design: a column-parallel reduction over the client axis.  Each thread
// owns columns (grid-stride), walks the m clients in registers and writes
// its column once; neighbouring threads read neighbouring addresses of each
// client row, as float4 when n % 4 == 0 and every pointer is 16-byte
// aligned.  The ragged tail is masked in the loop bound: nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

static __global__ void scaled_accum_vec4(const float4* __restrict__ x,
                                         const float* __restrict__ w,
                                         const float4* __restrict__ mask,
                                         float4* __restrict__ out,
                                         int64_t m, int64_t n4) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int64_t c = 0; c < m; ++c) {
      const float4 v = x[c * n4 + i];
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

static __global__ void scaled_accum_scalar(const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           const float* __restrict__ mask,
                                           float* __restrict__ out,
                                           int64_t m, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
#pragma unroll 4
    for (int64_t c = 0; c < m; ++c) acc += w[c] * x[c * n + i];
    out[i] = acc * mask[i];
  }
}

extern "C" int scaled_accum(const float* x, const float* w, const float* mask,
                            float* out, int64_t m, int64_t n, int sms,
                            void* stream) {
  const int threads = 256;
  const bool vec = (n % 4 == 0) && ((uintptr_t)x % 16 == 0) &&
                   ((uintptr_t)mask % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int64_t work = vec ? n / 4 : n;
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    scaled_accum_vec4<<<(unsigned)blocks, threads, 0, s>>>(
        (const float4*)x, w, (const float4*)mask, (float4*)out, m, work);
  else
    scaled_accum_scalar<<<(unsigned)blocks, threads, 0, s>>>(x, w, mask, out,
                                                             m, n);
  return (int)cudaGetLastError();
}
