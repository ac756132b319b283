// quantile_fused: per row, the trimmed-norm threshold and sum of squares
//   t[r]  = jnp.quantile(|rows[r]|, q[r])   (linear interpolation, bit-equal)
//   ss[r] = sum |rows[r]|^2 * [|rows[r]| <= t[r]]
//
// Replaces the TPU kernel repro/kernels/fedfa_quantile/kernel.py::
// quantile_fused (_quantile_fused_kernel).  Bound on the H100:
// device-memory bytes (each row read once: R * L * (4, 2 or 1) bytes at
// 3.35 TB/s).
//
// Design: each row is read from device memory once, into shared memory,
// and every pass of the select and the trimmed sum runs from there.  A
// row takes a thread-block cluster of cs CTAs (a power of two up to 8,
// chosen by kernels/fedfa_quantile/ops.py::cluster_geometry: at most 64 KB
// of the row a CTA where 8 CTAs allow it), each holding one part of the
// row: the main path's 110,592-element rows take 8 CTAs at f32, 4 at bf16
// and 2 at int8, 54 KB each, three CTAs an SM.
//  * The copy: 16-byte cp.async, all of a CTA's part in flight at once.  A
//    part is copied as the whole 16-byte vectors that overlap it, placed in
//    shared memory at its device-memory alignment, so that a row may start
//    anywhere (rows of odd length); elements outside the part are skipped.
//  * The select: the two bracketing order statistics are found exactly on
//    the bit pattern of |x| (monotone for nonnegative floats) in three
//    radix levels of 11, 10 and 10 bits (bits 20..30, 10..19, 0..9): each
//    level histograms the next bits of the elements whose higher bits match
//    the prefix resolved so far, and picks the bin that holds each rank.
//    The first level's 2048 bins spread normal data (sign 0, the exponent
//    and 3 mantissa bits) where one byte put 95 % of it in three bins.  The
//    floor and ceil ranks share one histogram while their prefixes agree
//    (always at the first level, almost always below it).  512 threads a
//    CTA, three CTAs an SM.
//  * The first level runs over the cluster, its histograms merged through
//    distributed shared memory: CTA k sums bins [k, k + 1) * bins / cs of
//    every CTA's histogram and writes the sums back into that share of
//    every CTA's (a share is read and written by its owner alone, so the
//    merge is in place); every CTA then holds the row's histogram and
//    picks both bins with one block scan.  Each select level run so over
//    the cluster cost about as much as the row's bytes, in barriers,
//    merges and scans, so the last two run in CTA 0 alone: each CTA sends
//    the elements of the bins from the floor statistic's to the ceil
//    statistic's (the candidates, a few percent of a normal row) to CTA 0
//    through distributed shared memory, and sums the squares of its
//    elements below them, which are all at most t.  Each candidate's place
//    in CTA 0 is fixed by its CTA, thread and order (a count, a block scan
//    and the cluster's counts, then a second pass that sends them), so CTA
//    0 sums them in the same order in every run and ss has the same bits.
//    Rows whose candidates CTA 0 cannot hold (ties, zeros at the rank) run
//    all three levels over the cluster.
//  * int8 rows need one level: |x * s| is a monotone function of |x| (one
//    rounding), so both statistics are found among the at most 129 values
//    of |x| in one 256-bin histogram over the cluster, and ss is summed
//    from the histogram's counts.
//  * The adds: one shared atomic an element in a bracket; a 16-byte
//    vector whose elements all fall in one bin (runs of zeros, ties) adds
//    once, and a warp none of whose vectors has an element in a bracket
//    skips the adds.  (Merging the runs of equal bins within a vector
//    measured slower on normal rows.)
//  * The rank arithmetic p = q * (L - 1), floor and frac are f32
//    operations with explicit round-to-nearest intrinsics (nothing is
//    contracted), and t = v0 * (1 - frac) + v1 * frac is the fused
//    fma(v1, frac, v0 * (1 - frac)) that XLA compiles jnp.quantile's
//    interpolation to on the CPU, so t matches the reference bit for bit.
// Quantized rows (int8 or bf16, with a per-row dequant scale s) are read in
// their own type and dequantized in registers as |(float)x * s| with
// __fmul_rn, which nvcc may not contract into a neighbouring add: the bits
// of that one rounded product are what the select walks, and they equal
// the JAX kernel's abs(x.astype(f32) * s).  Without a scale the rows are
// f32 and read as they are.
#include <cooperative_groups.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// The launch geometry's limits are set in kernels/fedfa_quantile/ops.py
// alone and passed as -D flags: the most CTAs of a cluster, a CTA's static
// shared memory at most, CTA 0's candidates in bytes, and all of a CTA's
// shared memory at most.
#if !defined(QF_MAX_CLUSTER) || !defined(QF_STATIC_SMEM) || \
    !defined(QF_GATHER) || !defined(QF_SMEM_MAX)
#error "build with the -D flags of kernels/fedfa_quantile/ops.py"
#endif
constexpr int kThreads = 512;
constexpr int kMaxCluster = QF_MAX_CLUSTER;
constexpr int kBins = 2048;              // the first level's; later 2 x 1024
constexpr int kStaticSmem = QF_STATIC_SMEM;
constexpr int kGather = QF_GATHER;
constexpr int kSmemMax = QF_SMEM_MAX;
static_assert(kMaxCluster % 4 == 0, "the merge loads four ranks at once");
static_assert((kSmemMax - kStaticSmem) / 16 + 1 <= 32 * kThreads,
              "a thread's vectors of a CTA's part fit a 32-bit mask");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// |x|'s bits for element u of a 16-byte vector, dequantized by s when the
// rows carry a scale
template <typename T, bool kScaled>
__device__ __forceinline__ uint32_t magnitude(const uint4& v, int u, float s) {
  const float x = to_f32(reinterpret_cast<const T*>(&v)[u]);
  return __float_as_uint(fabsf(kScaled ? __fmul_rn(x, s) : x));
}

// The select's key of element u of a vector: the bits of |x| (dequantized),
// or for int8 rows |x| itself.  |x * s| rounded once is round(|x| * |s|), a
// monotone function of |x|, so the order statistics of the magnitudes are
// those of |x|, which takes at most 129 values: one level of 256 bins
// finds both exactly, and every element of a bin has the same magnitude.
template <typename T, bool kScaled>
__device__ __forceinline__ uint32_t select_bits(const uint4& v, int u,
                                                float s) {
  if constexpr (std::is_same_v<T, int8_t>)
    return (uint32_t)abs((int)reinterpret_cast<const int8_t*>(&v)[u]);
  else
    return magnitude<T, kScaled>(v, u, s);
}

// words one CTA exchanges with the others of its cluster
struct Control {
  unsigned prefix[2];          // resolved high bits of each statistic
  int rank[2];                 // rank left inside the resolved bracket
  int count[kMaxCluster];      // each lower-ranked CTA's candidates
  int edge[kMaxCluster];       // each CTA's elements of the edge value
  float partial[kMaxCluster];  // each CTA's trimmed sum (CTA 0's copy)
};

template <typename T, bool kScaled>
__global__ void __launch_bounds__(kThreads, 3)
quantile_fused_kernel(const T* __restrict__ rows, const float* __restrict__ q,
                      const float* __restrict__ scale,
                      float* __restrict__ t_out, float* __restrict__ ss_out,
                      int L, int per) {
  // both ranks' prefix sums in one scan: path 0's count in the low 32 bits,
  // path 1's in the high (counts are below 2^30, so nothing carries)
  using Scan = cub::BlockScan<long long, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
  using IScan = cub::BlockScan<int, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
  using Reduce = cub::BlockReduce<float, kThreads>;
  __shared__ union {
    typename Scan::TempStorage scan;
    typename IScan::TempStorage iscan;
    typename Reduce::TempStorage reduce;
  } tmp;
  __shared__ __align__(16) int hist[kBins];
  __shared__ __align__(16) unsigned char gathered[kGather];  // CTA 0's
  __shared__ Control ctl;
  static_assert(sizeof(tmp) + sizeof(hist) + sizeof(gathered) + sizeof(ctl) <=
                    kStaticSmem,
                "ops.py::_STATIC_SMEM is too small");
  extern __shared__ __align__(16) unsigned char data[];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int k = (int)cluster.block_rank();
  const int64_t r = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31;
  constexpr int es = sizeof(T), V = 16 / es;
  const float sc = kScaled ? scale[r] : 1.f;

  // this CTA's elements [c0, c0 + n) of the row, and the 16-byte vectors of
  // device memory that hold them: element c0 at byte off0 of src = data.
  // (Once the candidates are gathered, CTA 0's elements are they, src =
  // gathered from byte 0.)
  const int c0 = k * per;
  const int n = max(0, min(L, c0 + per) - c0);
  const uintptr_t first = (uintptr_t)(rows + r * L + c0);
  const uintptr_t a0 = first & ~(uintptr_t)15;
  const unsigned char* src = data;
  int off0 = (int)(first - a0), nbytes = n * es;
  int nvec = n ? (off0 + nbytes + 15) / 16 : 0;
  for (int j = tid; j < nvec; j += kThreads) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(data + 16 * j);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(a0 + 16 * j)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const float p = __fmul_rn(q[r], (float)(L - 1));
  const float i0 = floorf(p);
  const float frac = __fsub_rn(p, i0);
  int rank[2] = {(int)i0, min((int)i0 + 1, L - 1)};
  unsigned prefix[2] = {0u, 0u};

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // element u of vector j is this CTA's (only the first and the last
  // vector hold others' elements)
  auto mine = [&](int j, int u) {
    const int o = 16 * j + u * es - off0;
    return o >= 0 && o < nbytes;
  };
  auto whole = [&](int j) {
    return 16 * j >= off0 && 16 * j + 16 <= off0 + nbytes;
  };

  // One level: the histogram of the next bits of the elements whose higher
  // bits match each statistic's prefix, merged over the cluster (or this
  // CTA's elements alone: local), and each statistic's bin.  The histogram
  // stays in hist.
  constexpr bool kInt8 = std::is_same_v<T, int8_t>;
  auto level = [&](int lv, bool local) {
    const int width = kInt8 ? 8 : lv ? 10 : 11;
    const int shift = kInt8 ? 0 : 20 - 10 * lv;
    const int hs = shift + width, nb = 1 << width, mask = nb - 1;
    const unsigned m0 = prefix[0] >> hs, m1 = prefix[1] >> hs;
    const bool same = m0 == m1;
    const int planes = same ? 1 : 2;   // plane p at hist + p * nb
    for (int i = tid; i < planes * nb; i += kThreads) hist[i] = 0;
    __syncthreads();

    // a vector whose elements all fall in one bin (runs of zeros, ties)
    // adds once; a warp none of whose vectors has an element in a bracket
    // skips the adds
    for (int jb = tid & ~31; jb < nvec; jb += kThreads) {
      const int j = jb + lane;
      int key[V];
#pragma unroll
      for (int u = 0; u < V; ++u) key[u] = -1;
      bool any = false, one = true;
      if (j < nvec) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * j);
        const bool all = whole(j);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          if (all || mine(j, u)) {
            const uint32_t bits = select_bits<T, kScaled>(v, u, sc);
            const unsigned hb = bits >> hs;
            if (hb == m0) key[u] = (bits >> shift) & mask;
            else if (hb == m1) key[u] = nb + ((bits >> shift) & mask);
          }
          any |= key[u] >= 0;
          one &= key[u] == key[0];
        }
      }
      if (!__any_sync(0xffffffffu, any)) continue;
      if (one) {
        if (key[0] >= 0) atomicAdd(&hist[key[0]], V);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u)
          if (key[u] >= 0) atomicAdd(&hist[key[u]], 1);
      }
    }

    if (local || cs == 1) {
      __syncthreads();
    } else {
      cluster.sync();  // every CTA's histogram is complete
      // the cluster's histogram in every CTA, in place: this CTA sums its
      // share of the bins over the cluster and writes the sums into every
      // CTA's share (a share is read and written by its owner alone)
      const int share = nb / cs, lo = k * share;   // a multiple of 4 bins
      for (int i = tid; i < planes * share / 4; i += kThreads) {
        const int pl = i / (share / 4);
        const int b = pl * nb + lo + 4 * (i - pl * (share / 4));
        int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
        for (int h = 0; h < kMaxCluster; h += 4) {  // four loads in flight
          int4 v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = h + j < cs ? *reinterpret_cast<const int4*>(
                                    cluster.map_shared_rank(hist, h + j) + b)
                              : make_int4(0, 0, 0, 0);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sum.x += v[j].x;
            sum.y += v[j].y;
            sum.z += v[j].z;
            sum.w += v[j].w;
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxCluster; ++j)
          if (j < cs)
            *reinterpret_cast<int4*>(cluster.map_shared_rank(hist, j) + b) =
                sum;
      }
      cluster.sync();  // every share's sums are everywhere
    }

    // each rank's bin: one scan of both planes' counts (the one plane twice
    // where the prefixes agree), each thread a run of bins
    const int each = (nb + kThreads - 1) / kThreads;
    const int b0 = min(nb, tid * each), b1 = min(nb, b0 + each);
    const int* h1 = hist + (same ? 0 : nb);
    long long c = 0;
    for (int b = b0; b < b1; ++b)
      c += (long long)hist[b] | ((long long)h1[b] << 32);
    if (tid == 0) {  // a level that finds no bin keeps the brackets
      ctl.prefix[0] = prefix[0];
      ctl.prefix[1] = prefix[1];
      ctl.rank[0] = rank[0];
      ctl.rank[1] = rank[1];
    }
    long long excl;
    Scan(tmp.scan).ExclusiveSum(c, excl);
#pragma unroll
    for (int path = 0; path < 2; ++path) {
      const int* h = path ? h1 : hist;
      int run = (int)(path ? excl >> 32 : excl & 0xFFFFFFFFll);
      const int cnt = (int)(path ? c >> 32 : c & 0xFFFFFFFFll);
      if (run <= rank[path] && rank[path] < run + cnt) {
        int b = b0;
        while (run + h[b] <= rank[path]) run += h[b++];
        ctl.prefix[path] = prefix[path] | ((unsigned)b << shift);
        ctl.rank[path] = rank[path] - run;
      }
    }
    __syncthreads();
    prefix[0] = ctl.prefix[0];
    prefix[1] = ctl.prefix[1];
    rank[0] = ctl.rank[0];
    rank[1] = ctl.rank[1];
  };

  // t from the two order statistics, and the squares of this CTA's elements
  // at most t
  auto threshold = [&]() {
    const float v0 = __uint_as_float(prefix[0]);
    const float v1 = __uint_as_float(prefix[1]);
    return __fmaf_rn(v1, frac, __fmul_rn(v0, __fsub_rn(1.f, frac)));
  };
  auto trimmed = [&](float t) {
    float acc = 0.f;
    for (int j = tid; j < nvec; j += kThreads) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * j);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float a = __uint_as_float(magnitude<T, kScaled>(v, u, sc));
        if (mine(j, u) && a <= t) acc += a * a;
      }
    }
    return Reduce(tmp.reduce).Sum(acc);
  };

  level(0, false);

  if constexpr (kInt8) {  // the bins are |x|, the histogram the row's
    auto mag = [&](int b) { return fabsf(__fmul_rn((float)b, sc)); };
    const float v0 = mag(prefix[0]), v1 = mag(prefix[1]);
    const float t = __fmaf_rn(v1, frac, __fmul_rn(v0, __fsub_rn(1.f, frac)));
    if (k) return;
    float sq = 0.f;
    if (tid < 256 && mag(tid) <= t) sq = (float)hist[tid] * (mag(tid) * mag(tid));
    const float total = Reduce(tmp.reduce).Sum(sq);
    if (tid == 0) {
      t_out[r] = t;
      ss_out[r] = total;
    }
    return;
  }

  // The candidates: the elements of the first level's bins from the floor
  // statistic's (b0) to the ceil statistic's (b1).  Every element of a
  // lower bin is at most t: t >= the float below v0 (with p >= 1, 1 - frac
  // is exact and t is at most half an ulp of v0 below it; with p < 1, v0
  // is the row's least element).  Every element of a higher bin is above
  // t, except the first float of bin b1 + 1 (the edge) when v1 is the last
  // float of bin b1: t <= the float above v1.  The edge's elements are
  // counted apart.  Where CTA 0 can hold the candidates, each CTA sums the
  // squares of its lower elements, counts its edge elements and sends its
  // candidates (in their own type) to CTA 0, and CTA 0 alone finishes.
  const int b0 = prefix[0] >> 20, b1 = prefix[1] >> 20;
  const unsigned edge = (unsigned)(b1 + 1) << 20;
  int in_range = 0;
  for (int b = tid; b < kBins; b += kThreads)
    if (b >= b0 && b <= b1) in_range += hist[b];
  int ignore, candidates;
  IScan(tmp.iscan).ExclusiveSum(in_range, ignore, candidates);
  __syncthreads();

  if (candidates > kGather / es) {  // the cluster finishes together
    level(1, false);
    level(2, false);
    const float t = threshold();
    const float total = trimmed(t);
    if (tid == 0) cluster.map_shared_rank(&ctl.partial[0], 0)[k] = total;
    cluster.sync();
    if (k == 0 && tid == 0) {
      float s = 0.f;
      for (int j = 0; j < cs; ++j) s += ctl.partial[j];
      t_out[r] = t;
      ss_out[r] = s;
    }
    return;
  }

  // the first pass: this thread's lower squares, candidates and edge
  // elements, and which of its vectors hold candidates (bit i: vector
  // tid + i * kThreads); the second sends its candidates to their places
  float low = 0.f;
  int own = 0, edges = 0;
  unsigned holds = 0u;
  for (int j = tid, i = 0; j < nvec; j += kThreads, ++i) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * j);
    const int before = own;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (!mine(j, u)) continue;
      const uint32_t bits = magnitude<T, kScaled>(v, u, sc);
      const int key = bits >> 20;
      if (key < b0) {
        const float a = __uint_as_float(bits);
        low += a * a;
      } else if (key <= b1) {
        ++own;
      } else {
        edges += bits == edge;
      }
    }
    if (own != before) holds |= 1u << i;
  }
  const float low_sum = Reduce(tmp.reduce).Sum(low);
  __syncthreads();
  // this thread's first place among the CTA's candidates in the low 32
  // bits, its edge elements' in the high; the CTA's totals likewise
  long long at, totals;
  Scan(tmp.scan).ExclusiveSum((long long)own | ((long long)edges << 32), at,
                              totals);
  if (tid == 0) {
    for (int j = k + 1; j < cs; ++j)
      cluster.map_shared_rank(&ctl.count[0], j)[k] = (int)totals;
    cluster.map_shared_rank(&ctl.partial[0], 0)[k] = low_sum;
    cluster.map_shared_rank(&ctl.edge[0], 0)[k] = (int)(totals >> 32);
  }
  cluster.sync();  // every CTA knows the counts of the CTAs before it
  int place = (int)at;
  for (int j = 0; j < k; ++j) place += ctl.count[j];
  T* cand0 = reinterpret_cast<T*>(cluster.map_shared_rank(gathered, 0));
  for (; holds; holds &= holds - 1u) {
    const int j = tid + (__ffs(holds) - 1) * kThreads;
    const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * j);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (!mine(j, u)) continue;
      const int key = magnitude<T, kScaled>(v, u, sc) >> 20;
      if (key >= b0 && key <= b1) {
        if (place < kGather / es)
          cand0[place] = reinterpret_cast<const T*>(&v)[u];
        ++place;
      }
    }
  }
  cluster.sync();  // CTA 0 holds every candidate
  if (k) return;

  src = gathered;
  off0 = 0;
  nbytes = candidates * es;
  nvec = (nbytes + 15) / 16;
  level(1, true);
  level(2, true);
  const float t = threshold();
  const float total = trimmed(t);
  if (tid == 0) {
    const float a = __uint_as_float(edge);
    float s = 0.f;
    int at_edge = 0;
    for (int j = 0; j < cs; ++j) {
      s += ctl.partial[j];
      at_edge += ctl.edge[j];
    }
    if (a <= t) s += (float)at_edge * (a * a);
    t_out[r] = t;
    ss_out[r] = t == t ? s + total : 0.f;  // nothing is <= NaN
  }
}

template <typename T, bool kScaled>
cudaError_t launch(const void* rows, const float* q, const float* scale,
                   float* t, float* ss, int R, int L, int cs, int per,
                   cudaStream_t s) {
  const size_t bytes = (size_t)per * sizeof(T) + 16;
  if (per % (16 / (int)sizeof(T)) || (int64_t)per * cs < L ||
      bytes + kStaticSmem > (size_t)kSmemMax)
    return cudaErrorInvalidValue;
  auto kernel = quantile_fused_kernel<T, kScaled>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(R * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, (const T*)rows, q, scale, t, ss, L,
                            per);
}

}  // namespace

// dtype: 0 = f32 rows, 1 = int8, 2 = bf16.  scale (R,) dequantizes the rows;
// it may be null only for f32 rows.  A row takes a cluster of `cluster` CTAs
// (a power of two up to kMaxCluster) of `per` elements each (a multiple of
// 16 bytes; cluster * per >= L): ops.py::cluster_geometry.
extern "C" int quantile_fused(const void* rows, int dtype, const float* q,
                              const float* scale, float* t, float* ss,
                              int64_t R, int64_t L, int cluster, int64_t per,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 0) return (int)cudaGetLastError();
  if (L < 1 || L >= (1LL << 30) || per < 1 || per >= (1LL << 30) ||
      R * cluster >= (1LL << 31) || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  const int r = (int)R, l = (int)L, c = cluster, pe = (int)per;
  if (dtype == 0 && scale == nullptr)
    return (int)launch<float, false>(rows, q, scale, t, ss, r, l, c, pe, s);
  if (dtype == 0)
    return (int)launch<float, true>(rows, q, scale, t, ss, r, l, c, pe, s);
  if (dtype == 1 && scale != nullptr)
    return (int)launch<int8_t, true>(rows, q, scale, t, ss, r, l, c, pe, s);
  if (dtype == 2 && scale != nullptr)
    return (int)launch<__nv_bfloat16, true>(rows, q, scale, t, ss, r, l, c,
                                            pe, s);
  return (int)cudaErrorInvalidValue;
}
