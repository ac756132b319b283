// hist_level: one refinement level of the multilevel trimmed quantile.
// For each row c, rank path p in {floor, ceil} and segment s, a 256-bin
// histogram of byte (bits(|x|) >> shift) & 0xFF over the elements of
// segment s whose higher bits (bits >> min(shift + 8, 31)) equal the
// resolved prefix hi[c, p, s]: per-bin counts (int32, exact) and sums of
// x^2, exact 64-bit integers in each bin's units (below).  Columns with
// seg_id -1 are inert.
//
// Replaces the TPU kernel repro/kernels/fedfa_quantile/multilevel.py::
// _hist_call (_hist_level_kernel).  Bound on the H100: device-memory bytes
// (x read once per level: m * C * (4, 2 or 1) bytes, plus the segment map
// once).
//
// Design, against what held the first version back: two shared atomics
// per element, contended (at the top level a row's elements fall into a
// handful of bins), one of them an f64 add, which sm_90 has no shared
// instruction for (the first version's SASS shows ATOMS.CAST.SPIN.64, a
// compare-and-swap loop); 4-byte loads; the segment map read per row.
//  * One plane where the prefixes agree.  Where hi[c, 0, s] == hi[c, 1, s]
//    (every segment at the top level, and nearly every one below it: the
//    floor and ceil ranks are adjacent) an element updates plane 0 only,
//    and the block copies plane 0 into plane 1 when it merges.
//  * Exact integer sums, no 64-bit shared atomic.  Every element of a bin
//    shares the bin's exponent range, so its square, scaled by a power of
//    two fixed by the bin, is an integer of at most 29 bits that keeps all
//    of a^2's bits.  A bin's sum is kept as two 32-bit words (the sums of
//    the low and the high 16 bits of its squares), each added natively, so
//    a block's sums are exact and their order does not matter.  (The first
//    version's block sums were f64 so that a bin's thousands of partial
//    sums would not lose 1e-5 of it; exact sums lose nothing.)
//  * Exact global planes.  The unit of a bin depends only on the row's
//    prefix, the shift and the bin, so every block of a row sums a bin in
//    one unit: each block adds its exact sum into a global 64-bit integer
//    plane (a native global atomicAdd), and the planes are the same
//    whatever the order of the blocks, of the columns, or of shards whose
//    planes are added.  The caller scales each bin once into f32
//    (repro_torch/kernels/fedfa_quantile/ref.py::scale_sums).  The counts
//    are int32, so the wrapper refuses rows of 2^31 elements or more; a
//    square is below 2^(kFrac + 5) units, so a bin's sum over such a row
//    stays below 2^60.
//  * Warp-level hot keys.  A warp keeps up to 3 keys (segment, bin) that
//    many of its lanes hold, with each lane's count and sum for them in
//    registers; only the other elements go to shared atomics.  At the top
//    level three bins take about 93 % of normal data.  At the end the
//    lanes' sums are reduced over the warp and added once.
//  * Private planes where S is small (S <= 4; S = 1 on the main path):
//    each warp owns its own planes (12 bytes a bin), so its lanes' atomics
//    meet no other warp's; the block merges its warps' planes.  For larger
//    S (up to 37) the planes are the block's.
//  * Wide loads (16 bytes of f32 or bf16, 8 of int8, and their segment
//    ids) where rows and segment map are so aligned, the next vector loaded
//    before the current one is binned; a warp votes once per vector and
//    skips it where no lane has a match, as at the lower levels nearly
//    every vector.  The grid runs the row as its fastest index, so the m
//    blocks of one column chunk run together and read its segment ids
//    from L2.
//  * Tried and measured slower: __match_any_sync groups with
//    __reduce_add_sync per group (their cost grows with the distinct keys
//    in a warp, so the second level, whose matching elements spread over
//    all 256 bins, took several times the first version's time); full-warp
//    ballot rounds per element; per-thread slots flushed on eviction.
// Quantized rows (int8 or bf16) come with per-(row, segment) dequant
// scales sc (m, S): each element is read in its own type and binned as
// |(float)x * sc[row, seg]|, the product rounded once by __fmul_rn (never
// contracted), which is the JAX kernel's abs(x.astype(f32) * scale).
// Without sc the rows are f32 and read as they are.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxSegments = 37;
constexpr int kPrivateSegments = 4;   // per-warp planes up to this S

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V elements of T, loaded at once (16 bytes when V * sizeof(T) == 16)
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T e[V];
};

// a^2 (finite f32) as an exact integer: a^2 * 2^(kFrac - 2 (ef - 127)),
// where ef is the lowest exponent field of a's bin, so a >= 2^(ef - 127):
// the result lies in [2^kFrac, 2^(kFrac + 5)), 32 bits, and (kFrac >= 23)
// no bit of a^2 is lost; squares below the f32 range are 0, as in f32
constexpr int kFrac = 24;
__device__ __forceinline__ uint32_t fixed_square(float a2, int ef) {
  const uint32_t b = __float_as_uint(a2);
  const int ea = b >> 23;
  const uint32_t mant = (b & 0x7FFFFFu) | (ea ? 0x800000u : 0u);
  const int sh = (ea ? ea : 1) + kFrac + 104 - 2 * ef;
  return mant ? mant << sh : 0;
}

// A bin's exact sum, kept in shared memory as two 32-bit words, the sums
// of the low and of the high 16 bits of its squares (sm_90 has no native
// 64-bit shared add: atomicAdd on 64 bits compiles to a compare-and-swap
// loop), so every add is a native one whose result nobody waits for.  A
// plane takes at most 2^16 elements (kMaxPlaneElems), so a word takes at
// most 2^16 adds (a warp's sum of a hot key replaces its elements' adds)
// and neither wraps.
constexpr int64_t kMaxPlaneElems = 1 << 16;
__device__ __forceinline__ void add_sum(unsigned* lo, unsigned* hi,
                                        uint64_t v) {
  atomicAdd(lo, (unsigned)(v & 0xFFFF));
  atomicAdd(hi, (unsigned)(v >> 16));
}

// A warp's running sums for up to kHot keys that many of its lanes hold
// (hot keys): the keys are the warp's, the counts and sums each lane's own,
// so an element of a hot key is added in registers.  A key becomes hot when
// kGroupMin lanes miss with it in one step and a hot slot is free; it stays
// hot for the block.  The other elements are added to the planes with
// shared integer atomics.  At the end the lanes' sums of each hot key are
// reduced over the warp and added once.
constexpr int kHot = 3, kGroupMin = 4;
struct HotKeys {
  int key[kHot], n[kHot];
  uint64_t s[kHot];

  __device__ __forceinline__ HotKeys() {
#pragma unroll
    for (int j = 0; j < kHot; ++j) {
      key[j] = -1;
      n[j] = 0;
      s[j] = 0;
    }
  }

  __device__ __forceinline__ bool hit(int k, uint32_t v) {
    bool found = false;
#pragma unroll
    for (int j = 0; j < kHot; ++j)
      if (k >= 0 && k == key[j]) {
        ++n[j];
        s[j] += v;
        found = true;
      }
    return found;
  }

  // every lane of the warp calls it together, k = -1 for no element
  __device__ __forceinline__ void add(int k, uint32_t v, int* cnt,
                                      unsigned* sq_lo, unsigned* sq_hi) {
    const bool hot = hit(k, v);
    unsigned lanes = __ballot_sync(0xffffffffu, k >= 0 && !hot);
    if (!lanes) return;
    int free = kHot;
#pragma unroll
    for (int j = kHot - 1; j >= 0; --j)
      if (key[j] < 0) free = j;
    if (free < kHot) {
      const int kk = __shfl_sync(0xffffffffu, k, __ffs(lanes) - 1);
      const unsigned same = __ballot_sync(0xffffffffu, k == kk && !hot);
      if (__popc(same) >= kGroupMin) {
        lanes &= ~same;
#pragma unroll
        for (int j = 0; j < kHot; ++j)
          if (j == free) {
            key[j] = kk;
            if (k == kk) {
              ++n[j];
              s[j] += v;
            }
          }
      }
    }
    if ((lanes >> (threadIdx.x & 31)) & 1) {
      atomicAdd(cnt + k, 1);
      add_sum(sq_lo + k, sq_hi + k, v);
    }
  }

  __device__ __forceinline__ void flush(int* cnt, unsigned* sq_lo,
                                        unsigned* sq_hi) {
#pragma unroll
    for (int j = 0; j < kHot; ++j) {
      if (key[j] < 0) continue;                 // the warp's, uniform
      const int tn = (int)__reduce_add_sync(0xffffffffu, (unsigned)n[j]);
      unsigned long long ts = s[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ts += __shfl_xor_sync(0xffffffffu, ts, off);
      if ((threadIdx.x & 31) == 0) {
        atomicAdd(cnt + key[j], tn);
        add_sum(sq_lo + key[j], sq_hi + key[j], ts);
      }
    }
  }
};

template <typename T, bool kScaled, int V, bool kPrivate>
__global__ void __launch_bounds__(kThreads)
hist_level_kernel(const T* __restrict__ x, const int* __restrict__ seg_id,
                  const float* __restrict__ sc, const int* __restrict__ hi,
                  int64_t C, int S, int shift, int64_t chunk,
                  int* __restrict__ cnt,
                  unsigned long long* __restrict__ sq) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_scale[kMaxSegments];
  __shared__ unsigned s_hi[2][kMaxSegments];
  __shared__ bool s_agree[kMaxSegments];

  const int nb = 2 * S * kBins;                 // bins of both planes
  const int copies = kPrivate ? kWarps : 1;
  int* scnt = reinterpret_cast<int*>(smem);
  unsigned* slo = reinterpret_cast<unsigned*>(scnt + copies * nb);
  unsigned* shi = slo + copies * nb;
  for (int i = threadIdx.x; i < 3 * copies * nb; i += kThreads) scnt[i] = 0;
  const int64_t row = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += kThreads) {
    s_scale[s] = kScaled ? sc[row * S + s] : 1.f;
    s_hi[0][s] = (unsigned)hi[row * 2 * S + s];
    s_hi[1][s] = (unsigned)hi[row * 2 * S + S + s];
    s_agree[s] = s_hi[0][s] == s_hi[1][s];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  int* wcnt = scnt + (kPrivate ? warp * nb : 0);
  unsigned* wlo = slo + (kPrivate ? warp * nb : 0);
  unsigned* whi = shi + (kPrivate ? warp * nb : 0);
  const int hs = shift + 8 < 31 ? shift + 8 : 31;
  const unsigned low = (1u << shift) - 1u;      // bits below the byte
  const T* xr = x + row * C;
  const int64_t lo = blockIdx.y * chunk;
  const int64_t end = lo + chunk < C ? lo + chunk : C;
  // each thread's columns, V at a time, the next V loaded before the
  // current ones are binned; every thread runs the same number of steps,
  // so the warp stays whole for its ballots, and columns past the chunk
  // are inert
  HotKeys hot;
  Vec<T, V> xv;
  Vec<int, V> sv;
  auto load = [&](int64_t c, Vec<T, V>& xn, Vec<int, V>& sn) {
    if (c >= end) {                              // V divides the chunk
#pragma unroll
      for (int i = 0; i < V; ++i) sn.e[i] = -1;
      return;
    }
    xn = *reinterpret_cast<const Vec<T, V>*>(xr + c);
    constexpr int W = V < 4 ? V : 4;             // ids per 16-byte load
#pragma unroll
    for (int i = 0; i < V; i += W)
      *reinterpret_cast<Vec<int, W>*>(sn.e + i) =
          *reinterpret_cast<const Vec<int, W>*>(seg_id + c + i);
  };
  const int64_t step = (int64_t)kThreads * V;
  const int64_t first = lo + (int64_t)threadIdx.x * V;
  load(first, xv, sv);
  for (int64_t base = lo; base < end; base += step) {
    Vec<T, V> xn;
    Vec<int, V> sn;
    load(base + step + (int64_t)threadIdx.x * V, xn, sn);
    // bin the vector, then none of the warp's work where no lane has a
    // match (below the top level, most steps)
    int key0[V], key1[V];
    unsigned bits[V];
    bool any0 = false, any1 = false;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int s = sv.e[i];
      key0[i] = key1[i] = -1;
      bits[i] = 0;
      if (s >= 0) {
        const float x1 = to_f32(xv.e[i]);
        bits[i] = __float_as_uint(kScaled ? fabsf(__fmul_rn(x1, s_scale[s]))
                                          : fabsf(x1));
        const unsigned hb = bits[i] >> hs;
        const int k = s * kBins + ((bits[i] >> shift) & 0xFF);
        if (hb == s_hi[0][s]) key0[i] = k;
        if (!s_agree[s] && hb == s_hi[1][s]) key1[i] = S * kBins + k;
      }
      any0 |= key0[i] >= 0;
      any1 |= key1[i] >= 0;
    }
    auto square = [&](int i) {
      const float a = __uint_as_float(bits[i]);
      return fixed_square(a * a, (bits[i] & ~low) >> 23);
    };
    if (__any_sync(0xffffffffu, any0))
#pragma unroll
      for (int i = 0; i < V; ++i)
        hot.add(key0[i], key0[i] >= 0 ? square(i) : 0, wcnt, wlo, whi);
    if (__any_sync(0xffffffffu, any1))
#pragma unroll
      for (int i = 0; i < V; ++i)
        hot.add(key1[i], key1[i] >= 0 ? square(i) : 0, wcnt, wlo, whi);
    xv = xn;
    sv = sn;
  }
  hot.flush(wcnt, wlo, whi);
  __syncthreads();

  // merge the warps' planes (exact integers, in any order), plane 1 of an
  // agreeing segment being plane 0, into the global integer planes
  int* gc = cnt + row * nb;
  unsigned long long* gs = sq + row * nb;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    const int p = i / (S * kBins), s = (i / kBins) % S;
    const int src = (p == 1 && s_agree[s]) ? i - S * kBins : i;
    int n = 0;
    unsigned long long t = 0;
#pragma unroll
    for (int w = 0; w < copies; ++w) {
      n += scnt[w * nb + src];
      t += ((unsigned long long)shi[w * nb + src] << 16) + slo[w * nb + src];
    }
    if (n) {
      atomicAdd(gc + i, n);
      atomicAdd(gs + i, t);
    }
  }
}

template <typename T, bool kScaled, int V, bool kPrivate>
int launch_with(const void* x, const int* seg_id, const float* sc,
                const int* hi, int* cnt, unsigned long long* sq, int64_t m,
                int64_t C,
                int S, int shift, int sms, cudaStream_t stream) {
  const size_t smem = (size_t)(kPrivate ? kWarps : 1) * 2 * S * kBins *
                      (sizeof(int) + 2 * sizeof(unsigned));
  auto kernel = hist_level_kernel<T, kScaled, V, kPrivate>;
  // (S = 1's private planes are 48 KB to the byte, beside the static ones)
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // about eight blocks per SM in all, each chunk a multiple of V columns
  int64_t per_row = ((int64_t)sms * 8 + m - 1) / m;
  const int64_t most = (C + kThreads * V - 1) / (kThreads * V);
  if (per_row > most) per_row = most;
  if (per_row < 1) per_row = 1;
  // a plane (a warp's, or the block's) takes at most kMaxPlaneElems
  const int64_t cap = kMaxPlaneElems * (kPrivate ? kWarps : 1);
  if (per_row < (C + cap - 1) / cap) per_row = (C + cap - 1) / cap;
  int64_t chunk = (C + per_row - 1) / per_row;
  chunk = (chunk + V - 1) / V * V;
  per_row = (C + chunk - 1) / chunk;
  if (per_row > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)m, (unsigned)per_row);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)x, seg_id, sc, hi, C, S,
                                           shift, chunk, cnt, sq);
  return (int)cudaGetLastError();
}

template <typename T, bool kScaled>
int launch(const void* x, const int* seg_id, const float* sc, const int* hi,
           int* cnt, unsigned long long* sq, int64_t m, int64_t C, int S,
           int shift, int sms, cudaStream_t s) {
  // 16-byte loads of f32 and bf16 rows, 8-byte ones of int8 rows (whose
  // 16 column ids per 16 bytes would take the registers)
  constexpr int V = sizeof(T) == 1 ? 8 : 16 / sizeof(T);
  // 16-byte loads need every row and the segment map so aligned
  const bool wide = C % V == 0 && (uintptr_t)x % 16 == 0 &&
                    (uintptr_t)seg_id % 16 == 0;
  if (S <= kPrivateSegments)
    return wide ? launch_with<T, kScaled, V, true>(x, seg_id, sc, hi, cnt, sq,
                                                   m, C, S, shift, sms, s)
                : launch_with<T, kScaled, 1, true>(x, seg_id, sc, hi, cnt, sq,
                                                   m, C, S, shift, sms, s);
  return wide ? launch_with<T, kScaled, V, false>(x, seg_id, sc, hi, cnt, sq,
                                                  m, C, S, shift, sms, s)
              : launch_with<T, kScaled, 1, false>(x, seg_id, sc, hi, cnt, sq,
                                                  m, C, S, shift, sms, s);
}

}  // namespace

// cnt (int32) and sq (64-bit integers) must be zeroed by the caller: blocks
// add into them.
// dtype: 0 = f32 rows, 1 = int8, 2 = bf16.  sc (m, S) dequantizes the rows;
// it may be null only for f32 rows.  1 <= S <= 37.
extern "C" int hist_level(const void* x, int dtype, const int* seg_id,
                          const float* sc, const int* hi, int* cnt,
                          unsigned long long* sq,
                          int64_t m, int64_t C, int S, int shift, int sms,
                          void* stream) {
  if (m == 0 || C == 0) return (int)cudaGetLastError();
  if (S < 1 || S > kMaxSegments) return (int)cudaErrorInvalidValue;
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
