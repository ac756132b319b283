// flash_attention: blockwise online-softmax GQA attention.
//   q (B, Sq, H, hd), k, v (B, Sk, K, hd), H % K == 0, all f32 or all bf16
//   (element-type code 0 or 2), upcast on load -> o (B, Sq, H, hd) in q's
//   type.  Mask: kpos < Sk, kpos <= qpos if causal, kpos > qpos - window if
//   window >= 0 (positions counted from 0 on both axes).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (_attn_kernel).  Bound on the H100: operations -- at the
// serving path's shape (8 x 4096 causal, 9 heads of 64) the products over
// the causal triangle are 4 * B * H * hd * S(S+1)/2 = 155 GFLOP, 2.3 ms at
// the 67 TFLOP/s f32 rate, against 0.06 ms for the bytes of q, k, v and o.
//
// Design: one block of 256 threads per (q tile of 64 rows, q head, batch);
// a loop over the kv tiles of 64 takes the place of the TPU grid's
// sequential kv axis.  The block keeps q (pre-scaled in f32, as the TPU
// kernel scales it before the product), one k and one v tile, and the
// 64 x 64 tile of probabilities in shared memory (rows padded by 4 floats,
// so the float4 reads of 8 neighbouring rows fall in distinct banks); the
// running max m, denominator l and the accumulator stay in registers.
// Thread (ty, tx) of the 16 x 16 grid owns rows 4ty..4ty+3 of the tile:
// s = q k^T for columns tx + 16c, c < 4 (a 4 x 4 register tile of f32
// FMAs; neighbouring threads read neighbouring k rows),
// the row max and sum by shuffles across the 16 threads of its half warp,
// and the accumulator's columns 4g..4g+3 for g = tx and g = tx + 16.  f32
// FMAs on the CUDA cores, no TF32: the f32 serving path is held to 2e-5.
// GQA goes through the index (kv head = h / (H / K)), so repeated k and v
// never reach memory.  kv tiles that the causal or window mask empties
// entirely are skipped: for them the reference's update is an exact no-op
// (m unchanged, corr = 1, p = 0), so no bit changes and the causal work
// halves.  Ragged Sq, Sk and any hd <= 128 that is a multiple of 8 are
// handled by bounds checks and zero-filled tiles; nothing is padded in
// device memory.  The heaviest causal q tiles are launched first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 256, kMaxHd = 128;
constexpr int kPLd = kBK + 4;                 // row stride of the p tile
constexpr float kNegInf = -1073741824.0f;     // -2^30, the reference's

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Rows [0, rows) of a tile whose row r starts at src + r * row_stride, times
// mul (rounded in f32), into dst (64 rows of stride ld); rows past `rows`
// are zero, so they add nothing to any sum.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const T* __restrict__ src,
                                          int64_t row_stride, int rows,
                                          int hd, float mul) {
  const int per_row = hd / 4;
  for (int c = threadIdx.x; c < kBQ * per_row; c += kThreads) {
    const int r = c / per_row, d = (c - r * per_row) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      v = load4(src + r * row_stride + d);
      v = make_float4(__fmul_rn(v.x, mul), __fmul_rn(v.y, mul),
                      __fmul_rn(v.z, mul), __fmul_rn(v.w, mul));
    }
    store4(dst + r * ld + d, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int H, int KH, int hd, int causal, int window,
                       float scale) {
  extern __shared__ float4 smem4[];
  const int ld = hd + 4;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * ld;
  float* Vs = Ks + kBK * ld;
  float* Ps = Vs + kBK * ld;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int q0 = qt * kBQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t q_stride = (int64_t)H * hd, kv_stride = (int64_t)KH * hd;

  load_tile(Qs, ld, q + (((int64_t)b * Sq + q0) * H + h) * hd, q_stride,
            min(kBQ, Sq - q0), hd, scale);

  float m[4], l[4];
  float4 acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int hd4 = hd / 4;
  const bool own0 = tx < hd4, own1 = tx + 16 < hd4;

  const int nk = (Sk + kBK - 1) / kBK;
  const int j_end = causal ? min(nk, (q0 + kBQ - 1) / kBK + 1) : nk;
  for (int j = 0; j < j_end; ++j) {
    const int k0 = j * kBK;
    if (window >= 0 && k0 + kBK - 1 <= q0 - window) continue;
    __syncthreads();  // the last tile's k, v and p are read
    const int64_t kv_off = (((int64_t)b * Sk + k0) * KH + kvh) * hd;
    const int kv_rows = min(kBK, Sk - k0);
    load_tile(Ks, ld, k + kv_off, kv_stride, kv_rows, hd, 1.f);
    load_tile(Vs, ld, v + kv_off, kv_stride, kv_rows, hd, 1.f);
    __syncthreads();

    // s = (q * scale) k^T on rows 4ty + i, columns tx + 16c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(Qs + (ty * 4 + i) * ld + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = load4(Ks + (tx + 16 * c) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qa[i].x, kb[c].x, s[i][c]);
          s[i][c] = fmaf(qa[i].y, kb[c].y, s[i][c]);
          s[i][c] = fmaf(qa[i].z, kb[c].z, s[i][c]);
          s[i][c] = fmaf(qa[i].w, kb[c].w, s[i][c]);
        }
    }

    // mask, online softmax, p into shared memory, rescale the accumulator
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool keep[4];
      float rmax = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        keep[c] = kpos < Sk && (!causal || kpos <= qpos) &&
                  (window < 0 || kpos > qpos - window);
        s[i][c] = keep[c] ? s[i][c] : kNegInf;
        rmax = fmaxf(rmax, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float p[4], rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = keep[c] ? expf(s[i][c] - m_new) : 0.f;
        rsum += p[c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(ty * 4 + i) * kPLd + tx + 16 * c] = p[c];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        acc[i][g].x *= corr;
        acc[i][g].y *= corr;
        acc[i][g].z *= corr;
        acc[i][g].w *= corr;
      }
    }
    __syncthreads();

    // acc += p v on rows 4ty + i, columns 4g..4g+3 for g = tx, tx + 16
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = load4(Ps + (ty * 4 + i) * kPLd + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * ld;
        const float4 v0 = own0 ? load4(vrow + 4 * tx) : make_float4(0, 0, 0, 0);
        const float4 v1 =
            own1 ? load4(vrow + 4 * (tx + 16)) : make_float4(0, 0, 0, 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? pa[i].x
                         : u == 1 ? pa[i].y
                         : u == 2 ? pa[i].z
                                  : pa[i].w;
          acc[i][0].x = fmaf(pu, v0.x, acc[i][0].x);
          acc[i][0].y = fmaf(pu, v0.y, acc[i][0].y);
          acc[i][0].z = fmaf(pu, v0.z, acc[i][0].z);
          acc[i][0].w = fmaf(pu, v0.w, acc[i][0].w);
          acc[i][1].x = fmaf(pu, v1.x, acc[i][1].x);
          acc[i][1].y = fmaf(pu, v1.y, acc[i][1].y);
          acc[i][1].z = fmaf(pu, v1.z, acc[i][1].z);
          acc[i][1].w = fmaf(pu, v1.w, acc[i][1].w);
        }
      }
    }
  }

  // o = acc / max(l, 1e-30) in q's type
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (((int64_t)b * Sq + row) * H + h) * hd;
    if (own0)
      store4(orow + 4 * tx,
             make_float4(acc[i][0].x / den, acc[i][0].y / den,
                         acc[i][0].z / den, acc[i][0].w / den));
    if (own1)
      store4(orow + 4 * (tx + 16),
             make_float4(acc[i][1].x / den, acc[i][1].y / den,
                         acc[i][1].z / den, acc[i][1].w / den));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KH, int hd, int causal, int window,
           float scale, cudaStream_t s) {
  const int ld = hd + 4;
  const size_t smem = ((size_t)(kBQ + 2 * kBK) * ld + kBQ * kPLd) *
                      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H, KH, hd, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 2 = bf16 (kernels/build.py DTYPE_CODES); window < 0 means
// no window.  The wrapper checks shapes, types, alignment and
// 8 <= hd <= 128 with hd % 8 == 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int B, int Sq, int Sk,
                               int H, int KH, int hd, int causal, int window,
                               float scale, void* stream) {
  if (hd < 8 || hd > kMaxHd || hd % 8 != 0 || KH < 1 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, Sq, Sk, H, KH, hd, causal, window,
                         scale, s);
  if (dtype == 2)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KH, hd, causal,
                                 window, scale, s);
  return (int)cudaErrorInvalidValue;
}
