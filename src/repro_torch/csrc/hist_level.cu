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
// are exact; the f32 sums vary in order).  Each thread first runs its
// elements through a register run-length accumulator, since at the top
// level most elements of a row fall into a handful of bins.  The TPU
// kernel's one-hot matmuls and its f32 prefix gather are artifacts of the
// MXU; here the prefix is compared as an integer.  The level loop,
// cumulative sums and bin pick stay in PyTorch (segmented_trimmed_stats).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;

struct Run {
  int key = -1;
  int n = 0;
  float s = 0.f;
  __device__ __forceinline__ void flush(int* cnt, float* sq) {
    if (n) {
      atomicAdd(&cnt[key], n);
      atomicAdd(&sq[key], s);
    }
  }
  __device__ __forceinline__ void add(int k, float a2, int* cnt, float* sq) {
    if (k != key) {
      flush(cnt, sq);
      key = k;
      n = 0;
      s = 0.f;
    }
    ++n;
    s += a2;
  }
};

__global__ void __launch_bounds__(kThreads)
hist_level_kernel(const float* __restrict__ x, const int* __restrict__ seg_id,
                  const int* __restrict__ hi, int64_t C, int S, int shift,
                  int64_t chunk, int* __restrict__ cnt,
                  float* __restrict__ sq) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = 2 * S * kBins;
  int* scnt = reinterpret_cast<int*>(smem);
  float* ssq = reinterpret_cast<float*>(smem + nb * sizeof(int));
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    scnt[i] = 0;
    ssq[i] = 0.f;
  }
  __syncthreads();

  const int64_t row = blockIdx.y;
  const float* xr = x + row * C;
  const int* hr = hi + row * 2 * S;
  const int hs = shift + 8 < 31 ? shift + 8 : 31;
  const int64_t lo = blockIdx.x * chunk;
  const int64_t end = lo + chunk < C ? lo + chunk : C;
  Run run0, run1;
  for (int64_t col = lo + threadIdx.x; col < end; col += kThreads) {
    const int s = seg_id[col];
    if (s < 0) continue;
    const float a = fabsf(xr[col]);
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
      atomicAdd(gs + i, ssq[i]);
    }
  }
}

}  // namespace

// cnt and sq must be zeroed by the caller: blocks add into them.
extern "C" int hist_level(const float* x, const int* seg_id, const int* hi,
                          int* cnt, float* sq, int64_t m, int64_t C, int S,
                          int shift, int sms, void* stream) {
  if (m == 0 || C == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)2 * S * kBins * (sizeof(int) + sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // about eight blocks per SM in all, each chunk at least 4 columns a thread
  int64_t per_row = ((int64_t)sms * 8 + m - 1) / m;
  const int64_t most = (C + 4 * kThreads - 1) / (4 * kThreads);
  if (per_row > most) per_row = most;
  if (per_row < 1) per_row = 1;
  const int64_t chunk = (C + per_row - 1) / per_row;
  per_row = (C + chunk - 1) / chunk;
  dim3 grid((unsigned)per_row, (unsigned)m);
  hist_level_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, seg_id, hi, C, S, shift, chunk, cnt, sq);
  return (int)cudaGetLastError();
}
