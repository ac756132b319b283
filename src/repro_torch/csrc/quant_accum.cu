// quant_accum: out[n] = sum_c x[c, n] * wtab[c, seg[n]] * mask[n]
// (the FedFA M' reduction of a quantized cohort, dequantization fused).
// x is int8 or bf16 and is upcast in registers; seg[n] = -1 adds nothing;
// wtab (m, S) holds the per-(client, segment) weight with the dequant
// scale, alpha, depth gate and data count folded in.
//
// Replaces the TPU kernel repro/kernels/fedfa_agg/kernel.py::quant_accum
// (_quant_accum_kernel).  Bound on the H100: device-memory bytes -- the
// (m, n) rows read once at b bytes each, seg, mask and out once:
// (m * b + 12) * n bytes at 3.35 TB/s; m multiply-adds per column.
//
// Design: scaled_accum's column-parallel reduction.  Each block first
// stages the (m, S) table in shared memory (dynamic, past 48 KB after
// raising the limit; the wrapper refuses tables past 227 KB), then each
// thread owns columns (grid-stride), reads seg once per column and walks
// the m clients in registers.  Neighbouring columns almost always share a
// segment, so a warp's table reads are shared-memory broadcasts.  Four
// columns a thread (char4 / two bf16x2, int4 for seg, float4 for mask and
// out) when n % 4 == 0 and every pointer is aligned; a scalar loop
// otherwise.  The TPU kernel's one-hot matmul gather is an artifact of
// the MXU: here the table is indexed directly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 load4(const int8_t* p, int64_t i4) {
  const char4 v = reinterpret_cast<const char4*>(p)[i4];
  return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int64_t i4) {
  const uint2 raw = reinterpret_cast<const uint2*>(p)[i4];
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void stage_table(float* tab, const float* wtab,
                                            int entries) {
  for (int i = threadIdx.x; i < entries; i += blockDim.x) tab[i] = wtab[i];
  __syncthreads();
}

// the table column of segment id s (clipped as the reference clips), or -1
__device__ __forceinline__ int column(int s, int S) {
  return s < 0 ? -1 : (s < S ? s : S - 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_accum_vec4(const T* __restrict__ x, const float* __restrict__ wtab,
                 const int4* __restrict__ seg, const float4* __restrict__ mask,
                 float4* __restrict__ out, int m, int S, int64_t n,
                 int64_t n4) {
  extern __shared__ float tab[];
  stage_table(tab, wtab, m * S);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int4 s = seg[i];
    const int cx = column(s.x, S), cy = column(s.y, S), cz = column(s.z, S),
              cw = column(s.w, S);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < m; ++c) {
      const float4 v = load4(x + (int64_t)c * n, i);
      const float* t = tab + c * S;
      if (cx >= 0) acc.x += v.x * t[cx];
      if (cy >= 0) acc.y += v.y * t[cy];
      if (cz >= 0) acc.z += v.z * t[cz];
      if (cw >= 0) acc.w += v.w * t[cw];
    }
    const float4 mk = mask[i];
    out[i] = make_float4(acc.x * mk.x, acc.y * mk.y, acc.z * mk.z,
                         acc.w * mk.w);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_accum_scalar(const T* __restrict__ x, const float* __restrict__ wtab,
                   const int* __restrict__ seg,
                   const float* __restrict__ mask, float* __restrict__ out,
                   int m, int S, int64_t n) {
  extern __shared__ float tab[];
  stage_table(tab, wtab, m * S);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int col = column(seg[i], S);
    float acc = 0.f;
    if (col >= 0) {
#pragma unroll 4
      for (int c = 0; c < m; ++c)
        acc += to_f32(x[(int64_t)c * n + i]) * tab[c * S + col];
    }
    out[i] = acc * mask[i];
  }
}

template <typename T>
int launch(const T* x, const float* wtab, const int* seg, const float* mask,
           float* out, int m, int S, int64_t n, int sms, cudaStream_t s) {
  const size_t smem = (size_t)m * S * sizeof(float);
  const bool vec = (n % 4 == 0) && ((uintptr_t)x % 16 == 0) &&
                   ((uintptr_t)seg % 16 == 0) && ((uintptr_t)mask % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (smem > 48 * 1024) {
    cudaError_t e = vec ? cudaFuncSetAttribute(
                              quant_accum_vec4<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem)
                        : cudaFuncSetAttribute(
                              quant_accum_scalar<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t work = vec ? n / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (vec)
    quant_accum_vec4<T><<<(unsigned)blocks, kThreads, smem, s>>>(
        x, wtab, (const int4*)seg, (const float4*)mask, (float4*)out, m, S, n,
        work);
  else
    quant_accum_scalar<T><<<(unsigned)blocks, kThreads, smem, s>>>(
        x, wtab, seg, mask, out, m, S, n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 = int8 rows, 2 = bf16 rows.
extern "C" int quant_accum(const void* x, int dtype, const float* wtab,
                           const int* seg, const float* mask, float* out,
                           int m, int S, int64_t n, int sms, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch((const int8_t*)x, wtab, seg, mask, out, m, S, n, sms, s);
  if (dtype == 2)
    return launch((const __nv_bfloat16*)x, wtab, seg, mask, out, m, S, n, sms,
                  s);
  return (int)cudaErrorInvalidValue;
}
