// flash_attention: blockwise online-softmax GQA attention on Hopper's
// tensor cores.
//   q (B, Sq, H, hd), k, v (B, Sk, K, hd), H % K == 0, all f32 or all bf16
//   (element-type code 0 or 2) -> o (B, Sq, H, hd) in q's type.  Mask:
//   kpos < Sk, kpos <= qpos if causal, kpos > qpos - window if window >= 0,
//   with key j at position j and query i at q_offset + i (q_offset >= 0: a
//   chunk of a chunked prefill against the whole cache; 0 otherwise).
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
// kernel is bounded by both.
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

    // mask, online softmax; thread holds columns 8c + 2t, 8c + 2t + 1 of
    // rows r0 (sc[4c], sc[4c + 1]) and r0 + 8 (sc[4c + 2], sc[4c + 3])
    // (the mask is applied only to tiles it cuts: the last, ragged one,
    // the causal diagonal and the window's edge)
    const int k0 = j * BK;
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
          ? exp_of<P::kSplit>(sc[e] - ((e & 2) ? mn1 : mn0)) : 0.f;
      sc[e] = p;
      if (e & 2) rs1 += p;
      else rs0 += p;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    const float corr0 = exp_of<P::kSplit>(m0 - mn0);
    const float corr1 = exp_of<P::kSplit>(m1 - mn1);
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int e = 0; e < HDP / 2; ++e) acc[e] *= (e & 2) ? corr1 : corr0;

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
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  T* og = o + ((int64_t)b * Sq * H + h) * hd;
#pragma unroll
  for (int c = 0; c < HDP / 8; ++c) {
    const int col = 8 * c + 2 * t;
    if (col >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0;
      if (row >= Sq) continue;
      const float den = half ? den1 : den0;
      const float x0 = acc[4 * c + 2 * half] / den;
      const float x1 = acc[4 * c + 2 * half + 1] / den;
      T* dst = og + (int64_t)row * q_stride + col;
      if constexpr (P::kSplit) {
        *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
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
// types, 16-byte alignment of k and v, and 8 <= hd <= 128 with hd % 8 == 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int B, int Sq, int Sk,
                               int H, int KH, int hd, int causal, int window,
                               int q_offset, float scale, void* stream) {
  if (hd < 8 || hd > kMaxHd || hd % 8 != 0 || KH < 1 || H % KH != 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
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
