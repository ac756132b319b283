// flash_attention: blockwise online-softmax GQA attention on Hopper's
// tensor cores.
//   q (B, Sq, H, hd), k, v (B, Sk, K, hd), H % K == 0, all f32 or all bf16
//   (element-type code 0 or 2) -> o (B, Sq, H, hd) in q's type.  Mask:
//   kpos < Sk, kpos <= qpos if causal, kpos > qpos - window if window >= 0,
//   with key j at position j and query i at q_offset + i (q_offset >= 0: a
//   chunk of a chunked prefill against the whole cache; 0 otherwise).
//
// Head widths: 8 <= hd <= 256, a multiple of 8.  hd <= 128 takes the
// kernel below; 128 < hd <= 256 (recurrentgemma-2b's 256) takes the wide
// kernel further down, two warpgroups a q head.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (_attn_kernel, its pallas_call at :90), with the
// reference's numbers: q scaled in f32 before the product, masked logits
// -2^30, the running max, denominator and accumulator in f32, the 1e-30
// floor on the denominator.
//
// Bound on the H100, at the serving path's shape (8 x 4096 causal, 9 q and
// 3 kv heads of 64): operations.  The products over the causal triangle
// are 4 * B * H * hd * S(S+1)/2 = 154.7 GFLOP: 0.156 ms at the 989 TFLOP/s
// bf16 tensor-core rate, 0.938 ms for the three TF32 products of the f32
// route at 495 TFLOP/s (the f32 CUDA-core route of the first version was
// bounded at 2.308 ms by 67 TFLOP/s); q, k, v and o are 201 MB (f32),
// 0.060 ms.  The 604 M exponentials of the triangle take 0.15 ms at the
// SFUs' 16 ex2 per clock and SM, beside the bf16 bound: on bf16 input the
// kernel is bounded by both.  At recurrentgemma-2b's serving shape (2 x
// 4096, 10 q heads and 1 kv head of 256, window 2048) the kept pairs give
// 128.9 GFLOP: 0.781 ms for the f32 route's three TF32 products, 0.130 ms
// in bf16; the 185 MB of q, k, v and o take 0.055 ms.
//
// Design.  A block serves W q heads of one kv head (W divides H / K and
// is at most 3; 3 on smollm) at one tile of 64 q positions: one warpgroup
// (128 threads) a head, so each K and V tile is read once for the W heads
// (one head a block measures slower: launch/ablate.py).  Each kv tile of BK
// rows (bf16 128, f32 64; 64 and 32 at hd > 64) comes in by cp.async into
// a ring of two stages, the next tile's copy in flight while the current
// one is used.  Both products run on the tensor cores through wgmma with
// f32 accumulators in registers: s = q k^T with q and k from shared
// memory, then o += p v with p from registers.
//  * bf16 (m64nNk16): q is rounded to bf16 once scaled.  hd = 64 scales by
//    0.125, a power of two, so the scaled q is exact; other widths round
//    it once.  p is rounded to bf16 for the second product, as SDPA does;
//    its row sum stays f32.  v is read as the transposed (MN-major) B
//    operand, so the tile is multiplied as it was copied.
//  * f32 by 3xTF32 (m64nNk8): each operand a splits into hi = tf32(a)
//    and lo = tf32(a - hi) (cvt.rna), and a product is lo.hi' + hi.lo' +
//    hi.hi', the small terms accumulated first; the dropped lo.lo' is
//    2^-22 of the product, which keeps the f32 path's 2e-5.  TF32 wgmma
//    takes both operands K-major, so the v tile is transposed in shared
//    memory as it is split.  The accumulator gives a thread columns
//    (2t, 2t+1) of each 8 where the TF32 A fragment wants (t, t + 4), so
//    the kv rows of the transposed v tile are stored in that permuted
//    order and p goes from the accumulator to the A fragment unmoved.
//    Each tile's p v is taken into a fresh accumulator and added to o with
//    f32 adds: summed by the tensor cores over all 64 kv tiles of the
//    serving path, o drifts from the exact 3xTF32 arithmetic by several
//    times what the split itself loses.
//  * Shared tiles use the canonical no-swizzle core-matrix layout (8 rows
//    of 16 bytes, 128 contiguous bytes a core matrix); hd is padded with
//    zeros to HDP (32, 64 or 128) inside shared memory only.
//  * The softmax runs in the accumulator's layout: a thread holds two rows
//    of the tile, each reduced over the four lanes of its quad by
//    shuffles; the rescale corr is applied to the accumulator in
//    registers.  The mask is applied only to the tiles it cuts (the last,
//    ragged one, the causal diagonal, the window's edge).  e^x is expf on
//    the f32 route, as the reference's; on the bf16 route, whose p is
//    rounded to bf16 for the product anyway, one ex2.approx (2 ulp).
// What holds it back (python -m repro_torch.launch.ablate; PERF.md): the
// k and v copies, each tile read again from L2 by every q tile of its
// head group (the loop with all of its compute taken out keeps most of
// the bf16 time), then the CUDA-core work around the products (softmax;
// on f32 the split pass), which the warpgroups of a block, held in step by
// the ring's barriers, do while the tensor cores wait.  Taking out either
// product alone saves little.
// kv tiles that the causal or window mask empties entirely are skipped:
// for them the reference's update is an exact no-op (m unchanged, corr =
// 1, p = 0).  Ragged Sq and Sk are handled by zero-filled copies and the
// mask; nothing is padded in device memory.  The heaviest causal q tiles
// are launched first: every tile of a launch has the same q_offset, so a
// tile's causal work still grows with its index.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;                       // q rows of a warpgroup
constexpr int kMaxHeadsPerBlock = 3;
constexpr int kMaxHd = 128;
constexpr int kSmemMax = 232448;              // a block's shared memory
constexpr float kNegInf = -1073741824.0f;     // -2^30, the reference's

// e^x: expf on the f32 route, as the reference; on the bf16 route, whose
// probabilities are rounded to bf16 (2^-9) for the product, one ex2.approx
// (2 ulp) of x log2(e)
template <bool kExact>
__device__ __forceinline__ float exp_of(float x) {
  if constexpr (kExact) {
    return expf(x);
  } else {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
    return y;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One kv tile's mask and online-softmax update, shared by both kernels.
// A thread holds columns 8c + 2t, 8c + 2t + 1 of rows r0 (sc[4c], sc[4c +
// 1]) and r0 + 8 (sc[4c + 2], sc[4c + 3]) of s, at query positions qpos0
// and qpos1; the tile's keys start at k0.  The mask is applied only to the
// tiles it cuts (the last, ragged one, the causal diagonal, the window's
// edge: p0 is the position of the block's first query).  On return sc
// holds p, the running max m and denominator l are updated, and acc (o's
// accumulator, in the same layout) is rescaled.
template <bool kExact, int BK, int NA>
__device__ __forceinline__ void softmax_step(float (&sc)[BK / 2],
                                             float (&acc)[NA], float& m0,
                                             float& m1, float& l0, float& l1,
                                             int k0, int Sk, int causal,
                                             int window, int p0, int qpos0,
                                             int qpos1, int t) {
  const bool cut = k0 + BK > Sk || (causal && k0 + BK - 1 > p0) ||
                   (window >= 0 && k0 <= p0 + kBQ - 1 - window);
  uint64_t keep = ~0ull;
  float mx0 = kNegInf, mx1 = kNegInf;
  if (cut) {
    keep = 0;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int kpos = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
      const int qpos = (e & 2) ? qpos1 : qpos0;
      const bool kp = kpos < Sk && (!causal || kpos <= qpos) &&
                      (window < 0 || kpos > qpos - window);
      keep |= (uint64_t)kp << e;
      sc[e] = kp ? sc[e] : kNegInf;
    }
  }
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    if (e & 2) mx1 = fmaxf(mx1, sc[e]);
    else mx0 = fmaxf(mx0, sc[e]);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const float p = ((keep >> e) & 1)
        ? exp_of<kExact>(sc[e] - ((e & 2) ? mn1 : mn0)) : 0.f;
    sc[e] = p;
    if (e & 2) rs1 += p;
    else rs0 += p;
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
  }
  const float corr0 = exp_of<kExact>(m0 - mn0);
  const float corr1 = exp_of<kExact>(m1 - mn1);
  l0 = l0 * corr0 + rs0;
  l1 = l1 * corr1 + rs1;
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] *= (e & 2) ? corr1 : corr0;
}

// o = acc / max(l, 1e-30) in T: columns col0 + 8c + 2t, + 1 (those below
// hd) of rows row0 and row1 (those below Sq), shared by both kernels.
template <typename T, int NA>
__device__ __forceinline__ void store_o(T* og, const float (&acc)[NA],
                                        float l0, float l1, int col0, int hd,
                                        int row0, int row1, int Sq,
                                        int64_t q_stride, int t) {
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int c = 0; c < NA / 4; ++c) {
    const int col = col0 + 8 * c + 2 * t;
    if (col >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0;
      if (row >= Sq) continue;
      const float den = half ? den1 : den0;
      const float x0 = acc[4 * c + 2 * half] / den;
      const float x1 = acc[4 * c + 2 * half + 1] / den;
      T* dst = og + (int64_t)row * q_stride + col;
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// Shared-memory plan of one block, in bytes: W q tiles (64 x HDP; two,
// hi and lo, on the f32 route), a ring of kStages stages of k and v tiles
// (BK x HDP), and on the f32 route the lo part of k and the hi and lo parts
// of the transposed v (HDP x BK).  Two stages: the next tile is copied
// while the current one is used.  (More stages on the bf16 route measured
// no faster: the copies are not what it waits for.)
template <typename T, int HDP, int BK>
struct Plan {
  static constexpr bool kSplit = sizeof(T) == 4;
  static constexpr int kStages = 2;
  static constexpr int es = sizeof(T);
  static constexpr int q_bytes = kBQ * HDP * es;
  static constexpr int tile_bytes = BK * HDP * es;
  static constexpr int sbo_rows = HDP * es * 8;    // k, v, q: rows of HDP
  static constexpr int sbo_vt = BK * es * 8;       // transposed v: rows of BK
  static constexpr size_t smem(int W) {
    return (size_t)(kSplit ? 2 : 1) * W * q_bytes +
           (size_t)(2 * kStages + (kSplit ? 3 : 0)) * tile_bytes;
  }
};

template <typename T, int HDP, int BK>
__global__ void __launch_bounds__(128 * kMaxHeadsPerBlock, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int H, int KH, int hd, int causal, int window,
                       int q_offset, float scale, int W) {
  using P = Plan<T, HDP, BK>;
  constexpr int es = P::es;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_hi = smem;
  unsigned char* q_lo = q_hi + W * P::q_bytes;          // f32 route
  unsigned char* stage = smem + (P::kSplit ? 2 : 1) * W * P::q_bytes;
  // stage s: k at stage + 2s * tile, v at stage + (2s + 1) * tile
  unsigned char* k_lo = stage + 2 * P::kStages * P::tile_bytes;  // f32
  unsigned char* vt_hi = k_lo + P::tile_bytes;
  unsigned char* vt_lo = vt_hi + P::tile_bytes;

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // Block n of the (q tile, head group, batch) grid, linearized, takes q
  // tile n / groups of head group n % groups: consecutive blocks read the
  // k and v of different head groups (not all the same lines of one), and
  // the heaviest causal q tiles go first
  const int G = H / KH, blocks_per_kv = G / W;
  const int groups = gridDim.y * gridDim.z;
  const int64_t n = blockIdx.x + (int64_t)gridDim.x *
                                     (blockIdx.y + (int64_t)gridDim.y *
                                                       blockIdx.z);
  const int grp = (int)(n % groups), gy = grp % gridDim.y;
  const int kvh = gy / blocks_per_kv;
  const int h = kvh * G + (gy % blocks_per_kv) * W + wg;
  const int b = grp / gridDim.y;
  const int q0 = (gridDim.x - 1 - (int)(n / groups)) * kBQ;
  const int p0 = q0 + q_offset;                 // row q0's position
  const int64_t q_stride = (int64_t)H * hd, kv_stride = (int64_t)KH * hd;

  // zero the stages: the columns past hd stay zero in every copy
  for (int i = tid; i < P::kStages * P::tile_bytes / 8; i += nthreads)
    reinterpret_cast<uint4*>(stage)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // this warpgroup's q tile, scaled in f32 (then split, or rounded to
  // bf16): 16-byte chunks, every load issued before the first store;
  // columns past hd and rows past Sq are zero
  {
    constexpr int E = 16 / es;                    // elements a chunk
    constexpr int kChunks = kBQ * HDP / E / 128;  // a thread's
    const T* qg = q + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * hd;
    uint4 raw[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int i = (tid & 127) + 128 * u, r = i / (HDP / E);
      const int c = (i - r * (HDP / E)) * E;
      raw[u] = (r < Sq - q0 && c < hd)
                   ? *reinterpret_cast<const uint4*>(qg + r * q_stride + c)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int i = (tid & 127) + 128 * u, r = i / (HDP / E);
      const int c = (i - r * (HDP / E)) * E;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      float x[E];
#pragma unroll
      for (int k = 0; k < E; ++k) x[k] = __fmul_rn(to_f32(e[k]), scale);
      const int off = cm_off(r, c, es, P::sbo_rows);  // one 16-byte chunk
      if constexpr (P::kSplit) {
        float4 hi, lo;
        float* hp = &hi.x;
        float* lp = &lo.x;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          hp[k] = tf32_rna(x[k]);
          lp[k] = tf32_rna(x[k] - hp[k]);
        }
        *reinterpret_cast<float4*>(q_hi + wg * P::q_bytes + off) = hi;
        *reinterpret_cast<float4*>(q_lo + wg * P::q_bytes + off) = lo;
      } else {
        uint4 packed;
        uint32_t* w = &packed.x;
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = pack_bf16(x[2 * k], x[2 * k + 1]);
        *reinterpret_cast<uint4*>(q_hi + wg * P::q_bytes + off) = packed;
      }
    }
  }

  // kv tiles [j_begin, j_end): those the mask leaves something of
  const int nk = (Sk + BK - 1) / BK;
  const int j_end = causal ? min(nk, (p0 + kBQ - 1) / BK + 1) : nk;
  int j_begin = 0;
  if (window >= 0 && p0 - window >= BK - 1)
    j_begin = (p0 - window - (BK - 1)) / BK + 1;

  // tile j's k and v rows into stage s, 16 bytes a thread, as one copy
  // group (empty past the last tile, so that every thread counts the same
  // groups); rows past Sk are zero-filled
  const int nch = hd * es / 16;                 // 16-byte chunks of a row
  const T* kg = k + (int64_t)b * Sk * kv_stride + (int64_t)kvh * hd;
  const T* vg = v + (int64_t)b * Sk * kv_stride + (int64_t)kvh * hd;
  auto load_tile = [&](int j, int s) {
    if (j >= j_end) {
      cp_async_commit();
      return;
    }
    const int k0 = j * BK;
    unsigned char* ks = stage + 2 * s * P::tile_bytes;
    unsigned char* vs = ks + P::tile_bytes;
    for (int c = tid; c < BK * nch; c += nthreads) {
      const int rg = c / (8 * nch), rem = c - rg * 8 * nch;
      const int ch = rem >> 3, row = rg * 8 + (rem & 7);
      const int off = rg * P::sbo_rows + ch * 128 + (rem & 7) * 16;
      const bool in = k0 + row < Sk;
      const int64_t src = in ? (int64_t)(k0 + row) * kv_stride + ch * (16 / es)
                             : 0;
      cp_async16(ks + off, kg + src, in ? 16 : 0);
      cp_async16(vs + off, vg + src, in ? 16 : 0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < P::kStages - 1; ++i) load_tile(j_begin + i, i);

  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int r0 = 16 * warp + g;                 // rows r0 and r0 + 8
  const int row0 = q0 + r0, row1 = row0 + 8;
  const int qpos0 = row0 + q_offset, qpos1 = qpos0 + 8;

  for (int j = j_begin, it = 0; j < j_end; ++j, ++it) {
    const int s = it % P::kStages;
    cp_async_wait<P::kStages - 2>();
    fence_async_smem();
    __syncthreads();  // tile j is in; every warpgroup is done with j - 1
    load_tile(j + P::kStages - 1, (it + P::kStages - 1) % P::kStages);
    unsigned char* ks = stage + 2 * s * P::tile_bytes;
    unsigned char* vs = ks + P::tile_bytes;
    if constexpr (P::kSplit) {
      // k in place -> hi, and its lo; v -> transposed hi and lo, its kv
      // rows permuted within each 8 to the TF32 A fragment's order.  A
      // 16-byte chunk at a time: columns d..d+3 of one kv row, which in the
      // transposed tile are 4 rows of one core matrix, 16 bytes apart.
      for (int i = tid; i < BK * HDP / 4; i += nthreads) {
        float4* kp = reinterpret_cast<float4*>(ks) + i;
        const float4 x = *kp;
        const float4 hi = make_float4(tf32_rna(x.x), tf32_rna(x.y),
                                      tf32_rna(x.z), tf32_rna(x.w));
        *kp = hi;
        reinterpret_cast<float4*>(k_lo)[i] =
            make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y),
                        tf32_rna(x.z - hi.z), tf32_rna(x.w - hi.w));
        const int byte = 16 * i, rg = byte / P::sbo_rows;
        const int rem = byte - rg * P::sbo_rows;
        const int kv = rg * 8 + ((rem & 127) >> 4), d = (rem >> 7) * 4;
        const int p = kv & 7, kvp = (kv & ~7) + (p >> 1) + 4 * (p & 1);
        const int vo = cm_off(d, kvp, 4, P::sbo_vt);
        const float4 y = reinterpret_cast<const float4*>(vs)[i];
        const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float yh = tf32_rna(yv[e]);
          *reinterpret_cast<float*>(vt_hi + vo + 16 * e) = yh;
          *reinterpret_cast<float*>(vt_lo + vo + 16 * e) = tf32_rna(yv[e] - yh);
        }
      }
      fence_async_smem();
      __syncthreads();
    }

    // s = (q * scale) k^T: 64 x BK in the accumulator's layout
    float sc[BK / 2];
    const unsigned char* qh = q_hi + wg * P::q_bytes;
    wgmma_fence();
    if constexpr (P::kSplit) {
      const unsigned char* ql = q_lo + wg * P::q_bytes;
      const unsigned char* a_op[3] = {ql, qh, qh};
      const unsigned char* b_op[3] = {ks, k_lo, ks};
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int kk = 0; kk < HDP / 8; ++kk)
          mma_ss<BK>(sc,
                     smem_desc(a_op[term] + kk * 256, 128, P::sbo_rows),
                     smem_desc(b_op[term] + kk * 256, 128, P::sbo_rows),
                     term + kk > 0, T());
    } else {
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        mma_ss<BK>(sc, smem_desc(qh + kk * 256, 128, P::sbo_rows),
                   smem_desc(ks + kk * 256, 128, P::sbo_rows), kk > 0, T());
    }
    wgmma_commit_wait();

    // mask, online softmax
    softmax_step<P::kSplit, BK>(sc, acc, m0, m1, l0, l1, j * BK, Sk, causal,
                                window, p0, qpos0, qpos1, t);

    // acc += p v
    wgmma_fence();
    if constexpr (P::kSplit) {
      // this tile's p v into a fresh accumulator, added to acc below with
      // f32 adds: the tensor cores' own sums over all kv tiles lose more
      float tile[HDP / 2];
#pragma unroll
      for (int e = 0; e < HDP / 2; ++e) tile[e] = 0.f;
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {
          // p's hi or lo in the A fragment's order (t, t + 4 <- 2t, 2t + 1)
          const float x[4] = {sc[4 * c], sc[4 * c + 2], sc[4 * c + 1],
                              sc[4 * c + 3]};
          uint32_t a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float h = tf32_rna(x[r]);
            a[r] = __float_as_uint(term == 0 ? tf32_rna(x[r] - h) : h);
          }
          mma_rs<HDP>(tile, a,
                      smem_desc((term == 1 ? vt_lo : vt_hi) + c * 256, 128,
                                P::sbo_vt),
                      T());
        }
      wgmma_commit_wait();
#pragma unroll
      for (int e = 0; e < HDP / 2; ++e) acc[e] += tile[e];
    } else {
      // v as copied (kv rows x HDP): MN-major, its 8-row groups of kv
      // sbo_rows apart and its 16-byte column chunks 128 apart
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        const float* pc = sc + 8 * c;
        const uint32_t a[4] = {pack_bf16(pc[0], pc[1]), pack_bf16(pc[2], pc[3]),
                               pack_bf16(pc[4], pc[5]), pack_bf16(pc[6], pc[7])};
        mma_rs<HDP>(acc, a,
                    smem_desc(vs + c * 2 * P::sbo_rows, P::sbo_rows, 128),
                    T());
      }
      wgmma_commit_wait();
    }
  }

  // o = acc / max(l, 1e-30) in q's type
  store_o(o + ((int64_t)b * Sq * H + h) * hd, acc, l0, l1, 0, hd, row0, row1,
          Sq, q_stride, t);
}

template <typename T, int HDP, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KH, int hd, int causal, int window,
           int q_offset, float scale, cudaStream_t s) {
  using P = Plan<T, HDP, BK>;
  const int G = H / KH;
  int W = 1;  // q heads per block: the most that divides G and fits
  for (int w = kMaxHeadsPerBlock; w > 1; --w)
    if (G % w == 0 && P::smem(w) <= (size_t)kSmemMax) {
      W = w;
      break;
    }
  const size_t smem = P::smem(W);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, HDP, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, KH * (G / W), B);
  flash_attention_kernel<T, HDP, BK><<<grid, 128 * W, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H, KH, hd,
      causal, window, q_offset, scale, W);
  return (int)cudaGetLastError();
}

// ---- hd 129..256: two warpgroups a q head ----------------------------
// One block takes one q head at one tile of 64 q positions, with two
// warpgroups: warpgroup w owns columns [128w, 128w + 128) of hd.  Each
// takes its half of s = q k^T (the product over its 128 columns of q and
// k), the two halves are summed through shared memory (s0 + s1, the same
// f32 sum on both), and both then run the same online softmax on the whole
// s and take p v into their own 128 columns of o.  So every register plan
// is the hd = 128 route's: o is 64 of a thread's registers, not 128.
//  * bf16: kv tiles of 64 rows in a ring of two stages by cp.async, as the
//    narrow kernel; q, the stages and the exchange take 192 KB.
//  * f32 (3xTF32): q's hi and lo parts alone take 128 KB, so the kv tile is
//    16 rows and no raw tile is kept in shared memory: each thread loads
//    its part of the next tile's k and v into registers (32 floats) before
//    the current tile's products, and splits it into k's hi and lo and the
//    transposed, permuted hi and lo of v at the top of the next step
//    (q 128 KB, the split tiles 64 KB, the exchange 8 KB).
// At hd 256 the scale 1/16 is a power of two, so the scaled q is exact in
// bf16 too.  The masks, the q offset, the tile skipping and the f32
// arithmetic (q scaled in f32, -2^30, f32 statistics, the 1e-30 floor) are
// the narrow kernel's.
constexpr int kWideHdp = 256;

template <typename T, int BK>
struct WidePlan {
  static constexpr bool kSplit = sizeof(T) == 4;
  static constexpr int kStages = 2;               // bf16 route's ring
  static constexpr int es = sizeof(T);
  static constexpr int q_bytes = kBQ * kWideHdp * es;
  static constexpr int tile_bytes = BK * kWideHdp * es;
  static constexpr int sbo_rows = kWideHdp * es * 8;
  static constexpr int sbo_vt = BK * es * 8;
  // byte offset of a warpgroup's 128 columns: in a K-major tile of rows
  // of kWideHdp (q, k; and v as copied, MN-major on the bf16 route), and in
  // the transposed v tile (rows of BK) of the f32 route
  static constexpr int half_cols = 128 * es / 16 * 128;
  static constexpr int half_vt = 128 / 8 * sbo_vt;
  static constexpr int exch_bytes = 2 * kBQ * BK * 4;
  static constexpr size_t smem() {
    return (size_t)(kSplit ? 2 : 1) * q_bytes +
           (size_t)(kSplit ? 4 : 2 * kStages) * tile_bytes + exch_bytes;
  }
};

template <typename T, int BK>
__global__ void __launch_bounds__(256, 1)
flash_attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            int Sq, int Sk, int H, int KH, int hd, int causal,
                            int window, int q_offset, float scale) {
  using P = WidePlan<T, BK>;
  constexpr int es = P::es, HDP = kWideHdp;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_hi = smem;
  unsigned char* q_lo = q_hi + P::q_bytes;                 // f32 route
  unsigned char* tiles = smem + (P::kSplit ? 2 : 1) * P::q_bytes;
  // f32: k hi, k lo, v^T hi, v^T lo; bf16: stage s's k at tiles + 2s *
  // tile, its v at tiles + (2s + 1) * tile
  unsigned char* k_hi = tiles;
  unsigned char* k_lo = tiles + P::tile_bytes;
  unsigned char* vt_hi = tiles + 2 * P::tile_bytes;
  unsigned char* vt_lo = tiles + 3 * P::tile_bytes;
  float* exch = reinterpret_cast<float*>(
      tiles + (P::kSplit ? 4 : 2 * P::kStages) * P::tile_bytes);

  const int tid = threadIdx.x, wg = tid >> 7, tw = tid & 127;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // block n of the (q tile, head, batch) grid, linearized, as the narrow
  // kernel: consecutive blocks take different heads, heaviest tiles first
  const int groups = gridDim.y * gridDim.z;
  const int64_t n = blockIdx.x + (int64_t)gridDim.x *
                                     (blockIdx.y + (int64_t)gridDim.y *
                                                       blockIdx.z);
  const int grp = (int)(n % groups), h = grp % gridDim.y;
  const int b = grp / gridDim.y, kvh = h / (H / KH);
  const int q0 = (gridDim.x - 1 - (int)(n / groups)) * kBQ;
  const int p0 = q0 + q_offset;
  const int64_t q_stride = (int64_t)H * hd, kv_stride = (int64_t)KH * hd;
  const T* kg = k + (int64_t)b * Sk * kv_stride + (int64_t)kvh * hd;
  const T* vg = v + (int64_t)b * Sk * kv_stride + (int64_t)kvh * hd;

  if constexpr (!P::kSplit) {
    // zero the stages: the columns past hd stay zero in every copy
    for (int i = tid; i < 2 * P::kStages * P::tile_bytes / 16; i += 256)
      reinterpret_cast<uint4*>(tiles)[i] = make_uint4(0, 0, 0, 0);
  }

  // the whole q tile, scaled in f32 (then split, or rounded to bf16), by
  // all 256 threads: every load issued before the first store
  {
    constexpr int E = 16 / es;
    constexpr int kChunks = kBQ * HDP / E / 256;
    const T* qg = q + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * hd;
    uint4 raw[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int i = tid + 256 * u, r = i / (HDP / E);
      const int c = (i - r * (HDP / E)) * E;
      raw[u] = (r < Sq - q0 && c < hd)
                   ? *reinterpret_cast<const uint4*>(qg + r * q_stride + c)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int i = tid + 256 * u, r = i / (HDP / E);
      const int c = (i - r * (HDP / E)) * E;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      float x[E];
#pragma unroll
      for (int kk = 0; kk < E; ++kk) x[kk] = __fmul_rn(to_f32(e[kk]), scale);
      const int off = cm_off(r, c, es, P::sbo_rows);
      if constexpr (P::kSplit) {
        float4 hi, lo;
        float* hp = &hi.x;
        float* lp = &lo.x;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hp[kk] = tf32_rna(x[kk]);
          lp[kk] = tf32_rna(x[kk] - hp[kk]);
        }
        *reinterpret_cast<float4*>(q_hi + off) = hi;
        *reinterpret_cast<float4*>(q_lo + off) = lo;
      } else {
        uint4 packed;
        uint32_t* w = &packed.x;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          w[kk] = pack_bf16(x[2 * kk], x[2 * kk + 1]);
        *reinterpret_cast<uint4*>(q_hi + off) = packed;
      }
    }
  }
  __syncthreads();

  // kv tiles [j_begin, j_end): those the mask leaves something of
  const int nk = (Sk + BK - 1) / BK;
  const int j_end = causal ? min(nk, (p0 + kBQ - 1) / BK + 1) : nk;
  int j_begin = 0;
  if (window >= 0 && p0 - window >= BK - 1)
    j_begin = (p0 - window - (BK - 1)) / BK + 1;

  // f32 route: a thread's float4s of one tile's k and v, row-major (rows
  // past Sk and columns past hd are zero)
  constexpr int kRaw = P::kSplit ? BK * HDP / 4 / 256 : 1;
  float4 rk[kRaw], rv[kRaw];
  auto fetch = [&](int j) {
#pragma unroll
    for (int u = 0; u < kRaw; ++u) {
      const int i = tid + 256 * u, row = i / (HDP / 4);
      const int c = (i - row * (HDP / 4)) * 4, kr = j * BK + row;
      const bool in = kr < Sk && c < hd;
      const int64_t src = (int64_t)kr * kv_stride + c;
      rk[u] = in ? *reinterpret_cast<const float4*>(
                       reinterpret_cast<const float*>(kg) + src)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      rv[u] = in ? *reinterpret_cast<const float4*>(
                       reinterpret_cast<const float*>(vg) + src)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // bf16 route: tile j's k and v rows into stage s by cp.async, as one
  // copy group (empty past the last tile); rows past Sk are zero-filled
  const int nch = hd * es / 16;
  auto load_tile = [&](int j, int s) {
    if (j >= j_end) {
      cp_async_commit();
      return;
    }
    const int k0 = j * BK;
    unsigned char* ks = tiles + 2 * s * P::tile_bytes;
    unsigned char* vs = ks + P::tile_bytes;
    for (int c = tid; c < BK * nch; c += 256) {
      const int rg = c / (8 * nch), rem = c - rg * 8 * nch;
      const int ch = rem >> 3, row = rg * 8 + (rem & 7);
      const int off = rg * P::sbo_rows + ch * 128 + (rem & 7) * 16;
      const bool in = k0 + row < Sk;
      const int64_t src = in ? (int64_t)(k0 + row) * kv_stride + ch * (16 / es)
                             : 0;
      cp_async16(ks + off, kg + src, in ? 16 : 0);
      cp_async16(vs + off, vg + src, in ? 16 : 0);
    }
    cp_async_commit();
  };
  if (j_begin < j_end) {
    if constexpr (P::kSplit) fetch(j_begin);
    else load_tile(j_begin, 0);
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int r0 = 16 * warp + g;
  const int row0 = q0 + r0, row1 = row0 + 8;
  const int qpos0 = row0 + q_offset, qpos1 = qpos0 + 8;

  for (int j = j_begin, it = 0; j < j_end; ++j, ++it) {
    unsigned char* ks;
    unsigned char* vs;
    if constexpr (P::kSplit) {
      __syncthreads();  // every warpgroup is done with tile j - 1
      // k -> hi and lo; v -> transposed hi and lo, its kv rows permuted
      // within each 8 to the TF32 A fragment's order (the narrow kernel's)
#pragma unroll
      for (int u = 0; u < kRaw; ++u) {
        const int i = tid + 256 * u, row = i / (HDP / 4);
        const int c = (i - row * (HDP / 4)) * 4;
        const float4 x = rk[u];
        const float4 hi = make_float4(tf32_rna(x.x), tf32_rna(x.y),
                                      tf32_rna(x.z), tf32_rna(x.w));
        const int ko = cm_off(row, c, 4, P::sbo_rows);
        *reinterpret_cast<float4*>(k_hi + ko) = hi;
        *reinterpret_cast<float4*>(k_lo + ko) =
            make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y),
                        tf32_rna(x.z - hi.z), tf32_rna(x.w - hi.w));
        const int p = row & 7, kvp = (row & ~7) + (p >> 1) + 4 * (p & 1);
        const int vo = cm_off(c, kvp, 4, P::sbo_vt);
        const float yv[4] = {rv[u].x, rv[u].y, rv[u].z, rv[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float yh = tf32_rna(yv[e]);
          *reinterpret_cast<float*>(vt_hi + vo + 16 * e) = yh;
          *reinterpret_cast<float*>(vt_lo + vo + 16 * e) = tf32_rna(yv[e] - yh);
        }
      }
      fence_async_smem();
      __syncthreads();
      if (j + 1 < j_end) fetch(j + 1);  // in flight during this tile's work
      ks = k_hi;
      vs = nullptr;
    } else {
      const int s = it % P::kStages;
      cp_async_wait<P::kStages - 2>();
      fence_async_smem();
      __syncthreads();  // tile j is in; every warpgroup is done with j - 1
      load_tile(j + P::kStages - 1, (it + P::kStages - 1) % P::kStages);
      ks = tiles + 2 * s * P::tile_bytes;
      vs = ks + P::tile_bytes;
    }

    // this warpgroup's half of s = (q * scale) k^T over its 128 columns
    float sc[BK / 2];
    const int half = wg * P::half_cols;
    wgmma_fence();
    if constexpr (P::kSplit) {
      const unsigned char* a_op[3] = {q_lo, q_hi, q_hi};
      const unsigned char* b_op[3] = {k_hi, k_lo, k_hi};
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int kk = 0; kk < 128 / 8; ++kk)
          mma_ss<BK>(sc,
                     smem_desc(a_op[term] + half + kk * 256, 128, P::sbo_rows),
                     smem_desc(b_op[term] + half + kk * 256, 128, P::sbo_rows),
                     term + kk > 0, T());
    } else {
#pragma unroll
      for (int kk = 0; kk < 128 / 16; ++kk)
        mma_ss<BK>(sc, smem_desc(q_hi + half + kk * 256, 128, P::sbo_rows),
                   smem_desc(ks + half + kk * 256, 128, P::sbo_rows), kk > 0,
                   T());
    }
    wgmma_commit_wait();
    // s = s0 + s1: each warpgroup adds the other's half (the same sum)
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) exch[(wg * (BK / 2) + e) * 128 + tw] = sc[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < BK / 2; ++e)
      sc[e] += exch[((1 - wg) * (BK / 2) + e) * 128 + tw];

    // mask, online softmax on the whole s
    softmax_step<P::kSplit, BK>(sc, acc, m0, m1, l0, l1, j * BK, Sk, causal,
                                window, p0, qpos0, qpos1, t);

    // acc += p v over this warpgroup's 128 columns
    wgmma_fence();
    if constexpr (P::kSplit) {
      float tile[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) tile[e] = 0.f;
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {
          const float x[4] = {sc[4 * c], sc[4 * c + 2], sc[4 * c + 1],
                              sc[4 * c + 3]};
          uint32_t a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float hv = tf32_rna(x[r]);
            a[r] = __float_as_uint(term == 0 ? tf32_rna(x[r] - hv) : hv);
          }
          mma_rs<128>(tile, a,
                      smem_desc((term == 1 ? vt_lo : vt_hi) + wg * P::half_vt +
                                    c * 256,
                                128, P::sbo_vt),
                      T());
        }
      wgmma_commit_wait();
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += tile[e];
    } else {
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        const float* pc = sc + 8 * c;
        const uint32_t a[4] = {pack_bf16(pc[0], pc[1]), pack_bf16(pc[2], pc[3]),
                               pack_bf16(pc[4], pc[5]), pack_bf16(pc[6], pc[7])};
        mma_rs<128>(acc, a,
                    smem_desc(vs + half + c * 2 * P::sbo_rows, P::sbo_rows,
                              128),
                    T());
      }
      wgmma_commit_wait();
    }
  }

  // o = acc / max(l, 1e-30) in q's type, this warpgroup's columns
  store_o(o + ((int64_t)b * Sq * H + h) * hd, acc, l0, l1, 128 * wg, hd, row0,
          row1, Sq, q_stride, t);
}

template <typename T, int BK>
int launch_wide(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Sk, int H, int KH, int hd, int causal, int window,
                int q_offset, float scale, cudaStream_t s) {
  const size_t smem = WidePlan<T, BK>::smem();
  static_assert(WidePlan<T, BK>::smem() <= (size_t)kSmemMax,
                "the wide plan exceeds a block's shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wide_kernel<T, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_wide_kernel<T, BK><<<grid, 256, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H, KH, hd, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T, int BK32, int BK64, int BK128>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int H, int KH, int hd, int causal, int window,
             int q_offset, float scale, cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 32, BK32>(q, k, v, o, B, Sq, Sk, H, KH, hd, causal,
                               window, q_offset, scale, s);
  if (hd <= 64)
    return launch<T, 64, BK64>(q, k, v, o, B, Sq, Sk, H, KH, hd, causal,
                               window, q_offset, scale, s);
  return launch<T, 128, BK128>(q, k, v, o, B, Sq, Sk, H, KH, hd, causal,
                               window, q_offset, scale, s);
}

}  // namespace

// dtype: 0 = f32, 2 = bf16 (kernels/build.py DTYPE_CODES); window < 0 means
// no window; a negative q_offset is refused.  The wrapper checks shapes,
// types, 16-byte alignment of k and v, and 8 <= hd <= 256 with hd % 8 == 0.
// hd <= 128 takes the narrow kernel, 128 < hd <= 256 the wide one.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int B, int Sq, int Sk,
                               int H, int KH, int hd, int causal, int window,
                               int q_offset, float scale, void* stream) {
  if (hd < 8 || hd > kWideHdp || hd % 8 != 0 || KH < 1 || H % KH != 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd > kMaxHd) {
    // kv tile rows: f32 16 (q's hi and lo take 128 KB), bf16 64
    if (dtype == 0)
      return launch_wide<float, 16>(q, k, v, o, B, Sq, Sk, H, KH, hd, causal,
                                    window, q_offset, scale, s);
    if (dtype == 2)
      return launch_wide<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, H, KH, hd,
                                            causal, window, q_offset, scale,
                                            s);
    return (int)cudaErrorInvalidValue;
  }
  // kv tile rows BK: f32 64, but 32 at hd > 64 (the split tiles' shared
  // memory); bf16 128, but 64 at hd > 64 (the registers of s and o)
  if (dtype == 0)
    return dispatch<float, 64, 64, 32>(q, k, v, o, B, Sq, Sk, H, KH, hd,
                                       causal, window, q_offset, scale, s);
  if (dtype == 2)
    return dispatch<__nv_bfloat16, 128, 128, 64>(q, k, v, o, B, Sq, Sk, H,
                                                 KH, hd, causal, window,
                                                 q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
