// quantile_fused: per row, the trimmed-norm threshold and sum of squares
//   t[r]  = jnp.quantile(|rows[r]|, q[r])   (linear interpolation, bit-equal)
//   ss[r] = sum |rows[r]|^2 * [|rows[r]| <= t[r]]
//
// Replaces the TPU kernel repro/kernels/fedfa_quantile/kernel.py::
// quantile_fused (_quantile_fused_kernel).  Bound on the H100:
// device-memory bytes (each row read once: R * L * 4 bytes at 3.35 TB/s).
//
// Design: one block per row.  A row of up to 2^18 f32 (1 MiB) does not fit
// in a block's shared memory, so it stays in device memory and is re-read
// from the 50 MB L2 on each pass.  The two bracketing order statistics are
// found exactly on the int32 bit pattern of |x| (monotone for nonnegative
// floats) by a 4-pass byte radix select: each pass builds a 256-bin
// shared-memory histogram of the next byte of the elements whose higher
// bytes match the prefix resolved so far, for both ranks at once, and a
// block-wide scan picks the bin holding the rank.  This yields the same
// bits as the TPU kernel's 31-step count-and-partition.  A fifth pass sums
// the trimmed squares.  The rank arithmetic p = q * (L - 1), floor and frac
// are f32 operations with explicit round-to-nearest intrinsics (nothing is
// contracted), and t = v0 * (1 - frac) + v1 * frac is the fused
// fma(v1, frac, v0 * (1 - frac)) that XLA compiles jnp.quantile's
// interpolation to on the CPU, so t matches the reference bit for bit.
//
// Quantized rows (int8 or bf16, with a per-row dequant scale s) are read in
// their own type and dequantized in registers as |(float)x * s| with
// __fmul_rn, which nvcc may not contract into a neighbouring add: the bits
// of that one rounded product are what the radix select walks, and they
// equal the JAX kernel's abs(x.astype(f32) * s).  Without a scale the rows
// are f32 and the kernel is the f32 one, unchanged.
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;  // one byte per pass; the scan gives thread b bin b

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// |x[i]|, dequantized by s when the rows carry a scale
template <typename T, bool kScaled>
__device__ __forceinline__ float magnitude(const T* x, int64_t i, float s) {
  if constexpr (kScaled) return fabsf(__fmul_rn(to_f32(x[i]), s));
  else return fabsf(to_f32(x[i]));
}

__device__ __forceinline__ void count_run(int* hist, int& cur, int& n, int b) {
  if (b != cur) {
    if (n) atomicAdd(&hist[cur], n);
    cur = b;
    n = 0;
  }
  ++n;
}

template <typename T, bool kScaled>
__global__ void __launch_bounds__(kThreads)
quantile_fused_kernel(const T* __restrict__ rows, const float* __restrict__ q,
                      const float* __restrict__ scale,
                      float* __restrict__ t_out, float* __restrict__ ss_out,
                      int64_t L) {
  using Scan = cub::BlockScan<int, kThreads>;
  using Reduce = cub::BlockReduce<float, kThreads>;
  __shared__ union {
    typename Scan::TempStorage scan;
    typename Reduce::TempStorage reduce;
  } tmp;
  __shared__ int hist[2][kBins];
  __shared__ unsigned prefix[2];  // resolved high bytes of each statistic
  __shared__ long long rank[2];   // rank left inside the resolved bracket

  const int64_t r = blockIdx.x;
  const T* x = rows + r * L;
  const float sc = kScaled ? scale[r] : 1.f;
  const int tid = threadIdx.x;

  const float p = __fmul_rn(q[r], (float)(L - 1));
  const float i0 = floorf(p);
  const float frac = __fsub_rn(p, i0);
  if (tid == 0) {
    const long long r0 = (long long)i0;
    rank[0] = r0;
    rank[1] = r0 + 1 < L - 1 ? r0 + 1 : L - 1;
    prefix[0] = prefix[1] = 0u;
  }

  for (int level = 0; level < 4; ++level) {
    const int shift = 24 - 8 * level;
    const int hs = shift + 8 < 31 ? shift + 8 : 31;  // bit 31 of |x| is 0
    hist[0][tid] = 0;
    hist[1][tid] = 0;
    __syncthreads();
    const unsigned pre0 = prefix[0] >> hs, pre1 = prefix[1] >> hs;
    // run-length counts in registers: a thread's elements often share a bin
    int cur0 = 0, n0 = 0, cur1 = 0, n1 = 0;
    for (int64_t i = tid; i < L; i += kThreads) {
      const unsigned bits = __float_as_uint(magnitude<T, kScaled>(x, i, sc));
      const int b = (bits >> shift) & 0xFF;
      const unsigned hb = bits >> hs;
      if (hb == pre0) count_run(hist[0], cur0, n0, b);
      if (hb == pre1) count_run(hist[1], cur1, n1, b);
    }
    if (n0) atomicAdd(&hist[0][cur0], n0);
    if (n1) atomicAdd(&hist[1][cur1], n1);
    __syncthreads();
    for (int path = 0; path < 2; ++path) {
      const int v = hist[path][tid];
      int incl;
      Scan(tmp.scan).InclusiveSum(v, incl);
      const long long rk = rank[path];
      const bool mine = (incl - v) <= rk && rk < incl;
      __syncthreads();
      if (mine) {
        prefix[path] |= (unsigned)tid << shift;
        rank[path] = rk - (incl - v);
      }
      __syncthreads();
    }
  }

  const float v0 = __uint_as_float(prefix[0]);
  const float v1 = __uint_as_float(prefix[1]);
  const float t = __fmaf_rn(v1, frac, __fmul_rn(v0, __fsub_rn(1.f, frac)));
  float acc = 0.f;
  for (int64_t i = tid; i < L; i += kThreads) {
    const float a = magnitude<T, kScaled>(x, i, sc);
    if (a <= t) acc += a * a;
  }
  const float total = Reduce(tmp.reduce).Sum(acc);
  if (tid == 0) {
    t_out[r] = t;
    ss_out[r] = total;
  }
}

template <typename T, bool kScaled>
void launch(const void* rows, const float* q, const float* scale, float* t,
            float* ss, int64_t R, int64_t L, cudaStream_t s) {
  quantile_fused_kernel<T, kScaled><<<(unsigned)R, kThreads, 0, s>>>(
      (const T*)rows, q, scale, t, ss, L);
}

}  // namespace

// dtype: 0 = f32 rows, 1 = int8, 2 = bf16.  scale (R,) dequantizes the rows;
// it may be null only for f32 rows.
extern "C" int quantile_fused(const void* rows, int dtype, const float* q,
                              const float* scale, float* t, float* ss,
                              int64_t R, int64_t L, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 0) return (int)cudaGetLastError();
  if (dtype == 0 && scale == nullptr)
    launch<float, false>(rows, q, scale, t, ss, R, L, s);
  else if (dtype == 0)
    launch<float, true>(rows, q, scale, t, ss, R, L, s);
  else if (dtype == 1 && scale != nullptr)
    launch<int8_t, true>(rows, q, scale, t, ss, R, L, s);
  else if (dtype == 2 && scale != nullptr)
    launch<__nv_bfloat16, true>(rows, q, scale, t, ss, R, L, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
