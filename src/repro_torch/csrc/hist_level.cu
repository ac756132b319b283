// hist_level: one refinement level of the multilevel trimmed quantile.
// For each row c, rank path p in {floor, ceil} and segment s, a 256-bin
// histogram of byte (bits(|x|) >> shift) & 0xFF over the elements of
// segment s whose higher bits (bits >> min(shift + 8, 31)) equal the
// resolved prefix hi[c, p, s]: per-bin counts (int32, exact) and sums of
// x^2 (f32).  Columns with seg_id -1 are inert.
//
// Replaces the TPU kernel repro/kernels/fedfa_quantile/multilevel.py::
// _hist_call (_hist_level_kernel).  Bound on the H100: device-memory bytes
// (x read once per level: m * C * 4 bytes, plus the segment map).
//
// Design: a block owns a (row, column-chunk) tile and builds its
// 2 x S x 256 count and sum planes in shared memory with shared atomics,
// then merges them into the global planes with atomicAdd (int32 counts
// are exact; the f32 sums vary in order).  The block's sums are f64: at
// the top level a few bins take thousands of partial sums each, one after
// another, and f32 would lose 1e-5 of them.  Each thread first runs its
// elements through a register run-length accumulator, since at the top
// level most elements of a row fall into a handful of bins.  The TPU
// kernel's one-hot matmuls and its f32 prefix gather are artifacts of the
// MXU; here the prefix is compared as an integer.  The level loop,
// cumulative sums and bin pick stay in PyTorch (segmented_trimmed_stats).
//
// Quantized rows (int8 or bf16) come with per-(row, segment) dequant
// scales sc (m, S): each element is read in its own type and binned as
// |(float)x * sc[row, seg]|, the product rounded once by __fmul_rn (never
// contracted), which is the JAX kernel's abs(x.astype(f32) * scale).
// Without sc the rows are f32 and the kernel is the f32 one, unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Run {
  int key = -1;
  int n = 0;
  double s = 0.0;
  __device__ __forceinline__ void flush(int* cnt, double* sq) {
    if (n) {
      atomicAdd(&cnt[key], n);
      atomicAdd(&sq[key], s);
    }
  }
  __device__ __forceinline__ void add(int k, float a2, int* cnt, double* sq) {
    if (k != key) {
      flush(cnt, sq);
      key = k;
      n = 0;
      s = 0.0;
    }
    ++n;
    s += a2;
  }
};

template <typename T, bool kScaled>
__global__ void __launch_bounds__(kThreads)
hist_level_kernel(const T* __restrict__ x, const int* __restrict__ seg_id,
                  const float* __restrict__ sc, const int* __restrict__ hi,
                  int64_t C, int S, int shift, int64_t chunk,
                  int* __restrict__ cnt, float* __restrict__ sq) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = 2 * S * kBins;
  double* ssq = reinterpret_cast<double*>(smem);
  int* scnt = reinterpret_cast<int*>(smem + nb * sizeof(double));
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    scnt[i] = 0;
    ssq[i] = 0.0;
  }
  __syncthreads();

  const int64_t row = blockIdx.y;
  const T* xr = x + row * C;
  const float* scr = kScaled ? sc + row * S : nullptr;
  const int* hr = hi + row * 2 * S;
  const int hs = shift + 8 < 31 ? shift + 8 : 31;
  const int64_t lo = blockIdx.x * chunk;
  const int64_t end = lo + chunk < C ? lo + chunk : C;
  Run run0, run1;
  for (int64_t col = lo + threadIdx.x; col < end; col += kThreads) {
    const int s = seg_id[col];
    if (s < 0) continue;
    const float a = kScaled ? fabsf(__fmul_rn(to_f32(xr[col]), scr[s]))
                            : fabsf(to_f32(xr[col]));
    const unsigned bits = __float_as_uint(a);
    const unsigned hb = bits >> hs;
    const int bin = (bits >> shift) & 0xFF;
    if (hb == (unsigned)hr[s]) run0.add(s * kBins + bin, a * a, scnt, ssq);
    if (hb == (unsigned)hr[S + s])
      run1.add((S + s) * kBins + bin, a * a, scnt, ssq);
  }
  run0.flush(scnt, ssq);
  run1.flush(scnt, ssq);
  __syncthreads();

  int* gc = cnt + row * nb;
  float* gs = sq + row * nb;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    if (scnt[i]) {
      atomicAdd(gc + i, scnt[i]);
      atomicAdd(gs + i, (float)ssq[i]);
    }
  }
}

template <typename T, bool kScaled>
int launch(const void* x, const int* seg_id, const float* sc, const int* hi,
           int* cnt, float* sq, int64_t m, int64_t C, int S, int shift,
           int sms, cudaStream_t stream) {
  const size_t smem = (size_t)2 * S * kBins * (sizeof(int) + sizeof(double));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_level_kernel<T, kScaled>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // at least eight blocks per SM in all, each chunk 4 to 32 columns a
  // thread: a longer chunk adds more partial sums into each shared f32 bin
  // one after another, and its rounding grows with their number (int8 rows,
  // whose squares repeat, showed it first)
  int64_t per_row = ((int64_t)sms * 8 + m - 1) / m;
  const int64_t most = (C + 4 * kThreads - 1) / (4 * kThreads);
  const int64_t least = (C + 32 * kThreads - 1) / (32 * kThreads);
  if (per_row > most) per_row = most;
  if (per_row < least) per_row = least;
  if (per_row < 1) per_row = 1;
  const int64_t chunk = (C + per_row - 1) / per_row;
  per_row = (C + chunk - 1) / chunk;
  dim3 grid((unsigned)per_row, (unsigned)m);
  hist_level_kernel<T, kScaled><<<grid, kThreads, smem, stream>>>(
      (const T*)x, seg_id, sc, hi, C, S, shift, chunk, cnt, sq);
  return (int)cudaGetLastError();
}

}  // namespace

// cnt and sq must be zeroed by the caller: blocks add into them.
// dtype: 0 = f32 rows, 1 = int8, 2 = bf16.  sc (m, S) dequantizes the rows;
// it may be null only for f32 rows.
extern "C" int hist_level(const void* x, int dtype, const int* seg_id,
                          const float* sc, const int* hi, int* cnt, float* sq,
                          int64_t m, int64_t C, int S, int shift, int sms,
                          void* stream) {
  if (m == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && sc == nullptr)
    return launch<float, false>(x, seg_id, sc, hi, cnt, sq, m, C, S, shift,
                                sms, s);
  if (dtype == 0)
    return launch<float, true>(x, seg_id, sc, hi, cnt, sq, m, C, S, shift,
                               sms, s);
  if (dtype == 1 && sc != nullptr)
    return launch<int8_t, true>(x, seg_id, sc, hi, cnt, sq, m, C, S, shift,
                                sms, s);
  if (dtype == 2 && sc != nullptr)
    return launch<__nv_bfloat16, true>(x, seg_id, sc, hi, cnt, sq, m, C, S,
                                       shift, sms, s);
  return (int)cudaErrorInvalidValue;
}
