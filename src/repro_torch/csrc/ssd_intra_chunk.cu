// ssd_intra_chunk: the intra-chunk term of Mamba-2's chunked SSD on
// Hopper's tensor cores.  For each chunk g and head h (Q positions, head
// width hp, state width N):
//   la = dt * A;  L = cumsum(la)
//   M[t, s] = (C_t . B_s) * exp(L_t - L_s) * dt_s   for s <= t, else 0
//   y = M x                                         (Q, hp)
//   state = x^T (B * dt * exp(L_{Q-1} - L))         (hp, N)
// and L itself, all f32, in the TPU kernel's layouts: y (G, Q, nh, hp),
// state (G, nh, hp, N), L (G, Q, nh).
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::ssd_intra_chunk
// (_ssd_kernel).  Bound on the H100 at the serving path's shape (G = 64
// chunks of 128, 24 heads of 64, state 128): bytes.  x, y and the state are
// 50.3 MB each at f32, with B, C, dt and L 161 MB in all: 0.048 ms at 3.35
// TB/s (bf16 x, B, C: 132 MB, 0.039 ms).  The three products over their
// causal triangles are 4.98 GFLOP: 0.030 ms as the f32 route's three TF32
// products each at 495 TFLOP/s (bf16: 0.020 ms), 0.074 ms as f32 on the
// CUDA cores (the first version's route).
//
// Design.  y = (C B^T * decay * dt) x has the shape of attention's p v: C
// plays q, B plays k, x plays v, and one 128-wide tile covers the chunk.
// A block (two warpgroups, 256 threads) takes one chunk and a group of hg
// heads (kernels/ssd/ops.py::heads_per_block): warpgroup w owns rows t of
// [64w, 64w + 64).
//  * C B^T once per block, into accumulators that stay in registers for
//    all hg heads: warpgroup 0 takes the 64 x 64 tile of its rows that the
//    causal mask leaves (s < 64), warpgroup 1 all 128 columns.  Its
//    operands are staged a slice of 32 state columns at a time (C and B
//    with their TF32 halves are 256 KB).
//  * Per head, M = C B^T * exp(L_t - L_s) * dt_s is formed in the
//    accumulator's layout and goes to the A fragment unmoved (p in
//    flash_attention.cu); y = M x with x^T from shared memory, over the
//    k-chunks of s below each warpgroup's diagonal only (warpgroup 0 skips
//    the upper tile).  Then the state, A = (x w)^T from registers (read
//    from x^T, scaled by w_s = dt_s exp(L_{Q-1} - L_s)), B = B^T from shared
//    memory; each warpgroup takes 64 of the N columns.
//  * TF32 wgmma takes both operands K-major, and s is the K of both of the
//    per-head products: x and B are stored transposed (x^T (hp, Q), B^T
//    (N, Q)), their s permuted within each 8 to the order in which the
//    accumulator gives a thread its columns (2t, 2t + 1 where the A
//    fragment wants t, t + 4).
//  * f32 by 3xTF32: each operand a splits into hi = tf32(a) and lo =
//    tf32(a - hi) (cvt.rna), and a product is lo.hi' + hi.lo' + hi.hi' (a
//    single TF32 product misses 1e-4).  bf16: C B^T in bf16 wgmma (exact
//    products, f32 sums); x and B are exact in TF32, so M x and the state
//    take two TF32 products, only M and x w split.
//  * Overlap: the next head's x is copied by cp.async into its own buffer
//    while this head is computed; y and the state go out of the
//    accumulators as 8-byte stores; the two warpgroups' products and
//    CUDA-core work interleave on the SM.  A k-chunk's three wgmmas are
//    waited for before the next chunk's fragments are formed: with more in
//    flight ptxas serialized every wgmma of the kernel for want of
//    registers (C7512), and measured slower.
//  * Shared memory, f32 (bf16 in brackets): B^T hi and lo 128 KB (64),
//    one region that holds the staged slices of C B^T and then x^T hi and
//    lo 64 KB (64, then 32), x as copied 32 KB (16), L, dt and w: 226 KB
//    (146), one block an SM.  Everything is padded to Q = N = 128, hp = 64
//    with zeros in shared memory; nothing is padded in device memory.
// L is summed in the order the reference's CPU code sums a cumulative sum
// (tiles of 16, see cumsum_like_xla), which the plain version follows too,
// so the kernel's L has the plain version's bits.  The exponent is formed
// only for s <= t (above the diagonal L_t - L_s > 0 could overflow, and
// inf * 0 is NaN); __fmul_rn keeps dt * A from being contracted into the
// first add; there is no fast math: expf, not __expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kQ = 128;         // chunk rows, padded
constexpr int kHp = 64;         // head width, padded
constexpr int kN = 128;         // state width, padded
constexpr int kSmemMax = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 4 consecutive f32 (16 bytes)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The chunk row s that storage position k of a transposed tile holds:
// within each 8, positions t and t + 4 hold rows 2t and 2t + 1
__device__ __forceinline__ int row_at(int k) {
  return (k & ~7) + 2 * (k & 3) + ((k >> 2) & 1);
}

// v's TF32 hi at hi + off and, on the split route, its lo at lo + off
template <bool kSplit>
__device__ __forceinline__ void store_split(unsigned char* hi,
                                            unsigned char* lo, int off,
                                            const float (&v)[4]) {
  float4 h, l;
  float* hp = &h.x;
  float* lp = &l.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hp[e] = tf32_rna(v[e]);
    lp[e] = tf32_rna(v[e] - hp[e]);
  }
  *reinterpret_cast<float4*>(hi + off) = h;
  if constexpr (kSplit) *reinterpret_cast<float4*>(lo + off) = l;
}

// a's TF32 hi and lo, as A-fragment registers
__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float h = tf32_rna(a[r]);
    hi[r] = __float_as_uint(h);
    lo[r] = __float_as_uint(tf32_rna(a[r] - h));
  }
}

// Inclusive prefix sum of a[0..n), n <= 256, in place, in the order XLA's
// CPU code adds a cumulative sum: a sequential sum within each tile of 16
// (one thread a tile, in registers), then each tile past the first adds the
// sequential sum of the totals of the tiles before it.  pre: n / 16 + 1
// floats of scratch.
__device__ void cumsum_like_xla(float* a, int n, float* pre) {
  const int tiles = (n + 15) / 16;
  if (threadIdx.x < tiles) {
    float* t = a + 16 * threadIdx.x;
    const int m = min(16, n - 16 * (int)threadIdx.x);
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = j < m ? t[j] : 0.f;
#pragma unroll
    for (int j = 1; j < 16; ++j) v[j] = v[j - 1] + v[j];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < m) t[j] = v[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = a[min(15, n - 1)];
    for (int k = 1; k < tiles; ++k) {
      pre[k] = run;
      run = run + a[min(16 * k + 15, n - 1)];
    }
  }
  __syncthreads();
  for (int i = 16 + threadIdx.x; i < n; i += kThreads)
    a[i] = a[i] + pre[i / 16];
  __syncthreads();
}

// Shared-memory plan of one block, in bytes (see the design note above).
template <typename T>
struct Plan {
  static constexpr bool kSplit = sizeof(T) == 4;
  static constexpr int kKN = kSplit ? 32 : kN;  // state columns staged at once
  static constexpr int bt = kN * kQ * 4;        // B^T, one TF32 half
  static constexpr int xt = kHp * kQ * 4;       // x^T, one TF32 half
  static constexpr int slice = kQ * kKN * (int)sizeof(T);  // C or B, staged
  static constexpr int region = (kSplit ? 2 : 1) * bt;
  static constexpr int staging = (kSplit ? 4 : 2) * slice;
  static constexpr int xts = (kSplit ? 2 : 1) * xt;
  static constexpr int xraw = region + (staging > xts ? staging : xts);
  static constexpr int small = xraw + kQ * kHp * (int)sizeof(T);
  static constexpr int bytes = small + (3 * kQ + kQ / 16 + 4) * 4;
  static constexpr int sbo_t = kQ * 4 * 8;      // B^T, x^T: rows of kQ
  static constexpr int sbo_slice = kKN * (int)sizeof(T) * 8;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_intra_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ B,
                       const T* __restrict__ C, float* __restrict__ y,
                       float* __restrict__ state, float* __restrict__ Lout,
                       int Q, int nh, int hp, int N, int hg) {
  using P = Plan<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* bt_hi = smem;                  // B^T (kN, kQ)
  unsigned char* bt_lo = smem + P::bt;          // f32 route
  unsigned char* stage = smem + P::region;      // C, B slices; then x^T
  unsigned char* xt_hi = stage;                 // x^T (kHp, kQ)
  unsigned char* xt_lo = stage + P::xt;         // f32 route
  T* xraw = reinterpret_cast<T*>(smem + P::xraw);  // x (kQ, kHp) as copied
  float* Ls = reinterpret_cast<float*>(smem + P::small);
  float* dts = Ls + kQ;
  float* wts = dts + kQ;                        // dt_s exp(L_{Q-1} - L_s)
  float* pre = wts + kQ;                        // scan scratch

  const int g = blockIdx.x, tid = threadIdx.x;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it as
  // uniform over the warp: wgmma under a branch it takes as divergent is
  // serialized
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int t0 = 64 * wg;                       // this warpgroup's rows of t
  const int ra = t0 + 16 * warp + gq, rb = ra + 8;
  const int pa = 16 * warp + gq, pb = pa + 8;   // its rows of the state
  const int64_t xs = (int64_t)nh * hp;          // x's row stride
  const T* Bg = B + (int64_t)g * Q * N;
  const T* Cg = C + (int64_t)g * Q * N;

  // x of head h into xraw (rows s < Q, columns p < hp), 4 elements a copy,
  // as one copy group
  auto load_x = [&](int h) {
    const T* src = x + (int64_t)g * Q * xs + (int64_t)h * hp;
    const int per_row = hp / 4;
    for (int i = tid; i < Q * per_row; i += kThreads) {
      const int s = i / per_row, p = (i - s * per_row) * 4;
      if constexpr (P::kSplit) cp_async16(xraw + s * kHp + p, src + s * xs + p, 16);
      else cp_async8(xraw + s * kHp + p, src + s * xs + p);
    }
    cp_async_commit();
  };
  load_x(blockIdx.y * hg);

  // B^T, split: 4 storage positions of one row n a thread, read from
  // device memory a row s at a time across the warp
  for (int i = tid; i < kN * (kQ / 4); i += kThreads) {
    const int n = i % kN, kc = i / kN;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = row_at(4 * kc + e);
      v[e] = (s < Q && n < N) ? to_f32(Bg[(int64_t)s * N + n]) : 0.f;
    }
    store_split<P::kSplit>(bt_hi, bt_lo, cm_off(n, 4 * kc, 4, P::sbo_t), v);
  }

  // C B^T over slices of kKN state columns: rows t (warpgroup 0: its 64 x
  // 64 causal tile; warpgroup 1: 64 x 128)
  float sacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
  for (int n0 = 0; n0 < N; n0 += P::kKN) {
    constexpr int per = kQ * (P::kKN / 4);      // 4-element items of a matrix
    for (int i = tid; i < 2 * per; i += kThreads) {
      const int mat = i / per, j = i - mat * per;   // mat 0: C, 1: B
      const int r = j % kQ, c = (j / kQ) * 4;
      const T* src = (mat ? Bg : Cg) + (int64_t)r * N + n0 + c;
      const bool in = r < Q && n0 + c < N;
      if constexpr (P::kSplit) {
        const float4 f = in ? load4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float v[4] = {f.x, f.y, f.z, f.w};
        unsigned char* base = stage + mat * 2 * P::slice;  // hi, then lo
        store_split<true>(base, base + P::slice, cm_off(r, c, 4, P::sbo_slice),
                          v);
      } else {
        const uint2 u = in ? *reinterpret_cast<const uint2*>(src)
                           : make_uint2(0u, 0u);
        *reinterpret_cast<uint2*>(stage + mat * P::slice +
                                  cm_off(r, c, 2, P::sbo_slice)) = u;
      }
    }
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
    const int a_row = (t0 / 8) * P::sbo_slice;
    auto cb = [&](uint64_t a, uint64_t b) {
      if (wg == 0)
        mma_ss<64>(*reinterpret_cast<float(*)[32]>(sacc), a, b, 1, T());
      else
        mma_ss<128>(sacc, a, b, 1, T());
    };
    if constexpr (P::kSplit) {
      const unsigned char* c_hi = stage;
      const unsigned char* c_lo = stage + P::slice;
      const unsigned char* b_hi = stage + 2 * P::slice;
      const unsigned char* b_lo = stage + 3 * P::slice;
      const unsigned char* a_op[3] = {c_lo, c_hi, c_hi};
      const unsigned char* b_op[3] = {b_hi, b_lo, b_hi};
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int kk = 0; kk < P::kKN / 8; ++kk) {
          const uint64_t a = smem_desc(a_op[term] + a_row + kk * 256, 128,
                                       P::sbo_slice);
          cb(a, smem_desc(b_op[term] + kk * 256, 128, P::sbo_slice));
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        const uint64_t a = smem_desc(stage + a_row + kk * 256, 128,
                                     P::sbo_slice);
        cb(a, smem_desc(stage + P::slice + kk * 256, 128, P::sbo_slice));
      }
    }
    wgmma_commit_wait();
    __syncthreads();  // before the next slice, or x^T, overwrites the stage
  }

  // k-chunks of 8 rows s: for y those below this warpgroup's diagonal and
  // Q, for the state those below Q
  const int ncy = t0 < Q ? (min(t0 + 64, Q) + 7) / 8 : 0;
  const int ncs = (Q + 7) / 8;
  const int bt_row = (64 * wg / 8) * P::sbo_t;  // this warpgroup's columns n

  for (int hh = 0; hh < hg; ++hh) {
    const int h = blockIdx.y * hg + hh;
    cp_async_wait<0>();
    __syncthreads();  // x is in; every thread is done with the last head
    const float Ah = A[h];
    for (int s = tid; s < kQ; s += kThreads) {
      const float d = s < Q ? dt[((int64_t)g * Q + s) * nh + h] : 0.f;
      dts[s] = d;
      Ls[s] = s < Q ? __fmul_rn(d, Ah) : 0.f;
    }
    // x -> x^T, split: 4 storage positions of one row p a thread
    for (int i = tid; i < kHp * (kQ / 4); i += kThreads) {
      const int p = i % kHp, kc = i / kHp;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = row_at(4 * kc + e);
        v[e] = (s < Q && p < hp) ? to_f32(xraw[s * kHp + p]) : 0.f;
      }
      store_split<P::kSplit>(xt_hi, xt_lo, cm_off(p, 4 * kc, 4, P::sbo_t), v);
    }
    __syncthreads();  // la is in; xraw is free for the next head's copy
    if (hh + 1 < hg) load_x(h + 1);
    cumsum_like_xla(Ls, Q, pre);
    for (int s = tid; s < kQ; s += kThreads) {
      if (s < Q) {
        Lout[((int64_t)g * Q + s) * nh + h] = Ls[s];
        wts[s] = dts[s] * expf(Ls[Q - 1] - Ls[s]);
      } else {
        wts[s] = 0.f;
      }
    }
    fence_async_smem();
    __syncthreads();  // x^T visible to wgmma; L and w to every thread

    // y = M x: a thread's M entries of chunk c are accumulator entries 4c..
    // 4c + 3, (ra, s0), (ra, s1), (rb, s0), (rb, s1)
    {
      float yacc[kHp / 2];
#pragma unroll
      for (int i = 0; i < kHp / 2; ++i) yacc[i] = 0.f;
      const float La = Ls[ra], Lb = Ls[rb];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        if (c >= ncy) break;
        const int s0 = 8 * c + 2 * tq, s1 = s0 + 1;
        const float L0 = Ls[s0], L1 = Ls[s1], d0 = dts[s0], d1 = dts[s1];
        const bool k0 = s0 <= ra && ra < Q, k1 = s1 <= ra && ra < Q;
        const bool k2 = s0 <= rb && rb < Q, k3 = s1 <= rb && rb < Q;
        const float e0 = expf(k0 ? La - L0 : 0.f), e1 = expf(k1 ? La - L1 : 0.f);
        const float e2 = expf(k2 ? Lb - L0 : 0.f), e3 = expf(k3 ? Lb - L1 : 0.f);
        // in the A fragment's order: (ra, k = tq), (rb, tq), (ra, tq + 4),
        // (rb, tq + 4)
        const float m[4] = {k0 ? (sacc[4 * c] * e0) * d0 : 0.f,
                            k2 ? (sacc[4 * c + 2] * e2) * d0 : 0.f,
                            k1 ? (sacc[4 * c + 1] * e1) * d1 : 0.f,
                            k3 ? (sacc[4 * c + 3] * e3) * d1 : 0.f};
        uint32_t hi[4], lo[4];
        split4(m, hi, lo);
        wgmma_fence();
        mma_rs<kHp>(yacc, lo, smem_desc(xt_hi + c * 256, 128, P::sbo_t),
                    float());
        if constexpr (P::kSplit)
          mma_rs<kHp>(yacc, hi, smem_desc(xt_lo + c * 256, 128, P::sbo_t),
                      float());
        mma_rs<kHp>(yacc, hi, smem_desc(xt_hi + c * 256, 128, P::sbo_t),
                    float());
        wgmma_commit();
        wgmma_wait<0>();
      }
#pragma unroll
      for (int c = 0; c < kHp / 8; ++c) {
        const int p = 8 * c + 2 * tq;
        if (p >= hp) break;
        if (ra < Q)
          *reinterpret_cast<float2*>(y + (((int64_t)g * Q + ra) * nh + h) * hp + p) =
              make_float2(yacc[4 * c], yacc[4 * c + 1]);
        if (rb < Q)
          *reinterpret_cast<float2*>(y + (((int64_t)g * Q + rb) * nh + h) * hp + p) =
              make_float2(yacc[4 * c + 2], yacc[4 * c + 3]);
      }
    }

    // state[p][n] = sum_s (x_s[p] w_s) B_s[n]: A = (x w)^T from registers,
    // read from x^T (hi + lo) at rows pa, pb and storage positions tq,
    // tq + 4 of chunk c (rows s0, s1); B = B^T, columns n of this
    // warpgroup
    {
      float st[kHp / 2];
#pragma unroll
      for (int i = 0; i < kHp / 2; ++i) st[i] = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        if (c >= ncs) break;
        const int s0 = 8 * c + 2 * tq;
        const float w0 = wts[s0], w1 = wts[s0 + 1];
        auto x_at = [&](int p, int k) {
          const int off = cm_off(p, 8 * c + k, 4, P::sbo_t);
          float v = *reinterpret_cast<const float*>(xt_hi + off);
          if constexpr (P::kSplit) v += *reinterpret_cast<const float*>(xt_lo + off);
          return v;
        };
        const float a[4] = {x_at(pa, tq) * w0, x_at(pb, tq) * w0,
                            x_at(pa, tq + 4) * w1, x_at(pb, tq + 4) * w1};
        uint32_t hi[4], lo[4];
        split4(a, hi, lo);
        wgmma_fence();
        mma_rs<64>(st, lo, smem_desc(bt_hi + bt_row + c * 256, 128, P::sbo_t),
                   float());
        if constexpr (P::kSplit)
          mma_rs<64>(st, hi, smem_desc(bt_lo + bt_row + c * 256, 128, P::sbo_t),
                     float());
        mma_rs<64>(st, hi, smem_desc(bt_hi + bt_row + c * 256, 128, P::sbo_t),
                   float());
        wgmma_commit();
        wgmma_wait<0>();
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = 64 * wg + 8 * c + 2 * tq;
        if (n >= N) break;
        float* row = state + ((int64_t)g * nh + h) * hp * N + n;
        if (pa < hp)
          *reinterpret_cast<float2*>(row + (int64_t)pa * N) =
              make_float2(st[4 * c], st[4 * c + 1]);
        if (pb < hp)
          *reinterpret_cast<float2*>(row + (int64_t)pb * N) =
              make_float2(st[4 * c + 2], st[4 * c + 3]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* state,
                   void* L, int G, int Q, int nh, int hp, int N, int hg,
                   cudaStream_t stream) {
  constexpr int bytes = Plan<T>::bytes;
  static_assert(bytes <= kSmemMax, "one block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  ssd_intra_chunk_kernel<T><<<dim3(G, nh / hg), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(state), static_cast<float*>(L), Q, nh, hp, N, hg);
  return cudaGetLastError();
}

}  // namespace

// x (G, Q, nh, hp) and B, C (G, Q, N) of element type `dtype` (0 f32,
// 2 bf16), dt (G, Q, nh) and A (nh,) f32; y, state, L as above.  Takes
// Q <= 128, N <= 128, hp <= 64, each a multiple of 4, hg dividing nh, and
// x, B and C 16-byte aligned.
extern "C" int ssd_intra_chunk(const void* x, int dtype, const void* dt,
                               const void* A, const void* B, const void* C,
                               void* y, void* state, void* L, int G, int Q,
                               int nh, int hp, int N, int hg, void* stream) {
  if (G < 1 || Q < 4 || Q > kQ || N < 4 || N > kN || hp < 4 || hp > kHp ||
      Q % 4 || N % 4 || hp % 4 || hg < 1 || nh % hg ||
      ((uintptr_t)x | (uintptr_t)B | (uintptr_t)C) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, dt, A, B, C, y, state, L, G, Q, nh, hp, N,
                              hg, s);
  if (dtype == 2)
    return (int)launch<__nv_bfloat16>(x, dt, A, B, C, y, state, L, G, Q, nh,
                                      hp, N, hg, s);
  return (int)cudaErrorInvalidValue;
}
