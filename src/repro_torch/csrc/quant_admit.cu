// quant_admit: quantized admission with server-side error feedback, one
// streaming pass of three over the f32 cohort.  For client c and element n
// of a piece (whole segment rows of one leaf):
//
//   y = (x[c, src(n)] + e_q[c, n] * e_s[c, seg]) * dens[c, n]
//   (x_q, s)   = quantize(y)          s   = max|y| / 127 per (c, seg)
//   e          = y - x_q * s
//   (e_q, e_s) = quantize(e)          e_s = max|e| / 127 per (c, seg)
//
// src(n) applies the graft (Alg. 2): on a stage-0 leaf, destination row r
// of client c reads row gmaps[c, r] of the same leaf, whole and contiguous.
// dens is the product of the client's width masks along the leaf's axes
// within a row (up to two factors, each a vector of the (m, F) factor
// table indexed by (column / stride) % dim).
//
//   step 1: y; atomicMax of max|y| into ymax (m, S)
//   step 2: y, x_q; atomicMax of max|e| into emax (m, S)
//   step 3: y, x_q, e, e_q; x_q and e_q written (int8).  bf16 admission
//           takes this step alone: x_q = bf16(y), e_q = bf16(y - x_q), with
//           unit scales and no maxima.
//
// The new e_s is not written here: step 3 still reads the old one.  The
// caller writes both scale tables from ymax and emax afterwards, and on a
// mesh all-reduces ymax and emax over the model axis between the steps.
//
// Replaces no TPU kernel: the reference admits in plain jnp
// (repro/core/round.py, _round_q), and the port's plain version
// (kernels/fedfa_agg/ref.py, quant_admit_ref) is a chain of some 25
// elementwise PyTorch kernels a piece, each reading and writing (m, piece)
// f32 rows.  Added for the byte bound of the work on the H100: the f32 rows
// and the residual read three times and x_q, e_q written once, at m = 16 on
// smollm-135m ~36.6 GB, ~10.9 ms at 3.35 TB/s.
//
// Bits: every product, sum and quotient is written out with its rounding
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc contracts nothing
// into an FMA; rintf rounds half to even as torch.round; the scale is
// max * fl(1/127), as PyTorch computes `seg_max / 127.0` on a CUDA tensor
// (a CPU-scalar divisor becomes a multiply by its reciprocal); y / scale is
// a true division, as PyTorch divides two CUDA tensors.  The maxima are
// order-free (atomicMax on the bits of non-negative floats; a NaN's bits
// exceed every number's, so it propagates as torch.amax propagates it), so
// every run gives the same bits.
//
// Design: tiles of at most kTile elements of one segment row; one block
// works a (tile, client) pair at a time, persistent over the grid, and
// reads the tile's descriptors, scales and factor pointers once for its
// chunks of kChunk elements.  The vector route moves 16 bytes of x a thread
// (float4) with char4 / 2 x bf16x2 of e_q when every offset of the piece is
// a multiple of 4; the scalar route takes any other piece.  Each thread
// issues its loads for a whole chunk before computing (kUnroll independent
// loads in flight); a tile's max is a warp shuffle, a shared-memory step
// and one atomicMax.  A quotient v / scale is only rounded to an integer,
// so it is taken as v * fl(1/scale) and divided exactly only where that
// product lies within 2^-14 of a half-integer (or is not finite): the
// product is within 2^-15 of the true quotient below 256, so elsewhere both
// round to the same integer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 4 blocks of 256 an SM (64 registers a thread) with 2 chunks of loads in
// flight took 14.2 ms for an m = 16 smollm-135m int8 admission on an H100,
// against 16.3 ms at 2 blocks and 4 (and 14.7 at 3 and 4, 15.4 at 4 and 4,
// which spills)
constexpr int kMinBlocks = 4;
constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr int kChunk = kThreads * 4 * kUnroll;
constexpr int kTile = 32768;                    // the wrapper's ADMIT_TILE
constexpr int kMaxFactors = 2;
constexpr float kInv127 = 1.0f / 127.0f;
constexpr float kNearHalf = 1.0f / 16384.0f;    // 2^-14

// fields of a piece's row in the int64 piece table (ops.AdmitPlan)
enum {
  P_SEG0, P_REST, P_A, P_XOFF, P_ROWLEN, P_J0, P_C0, P_STAGE0, P_VEC, P_NF,
  P_F0
};
// fields of each factor: the column of its vector in the factor table,
// then (mul, shift, d) of its stride and of its dim for the division by
// multiplication
enum { F_COL, F_SMUL, F_SSHIFT, F_SD, F_DMUL, F_DSHIFT, F_DD, F_FIELDS };
constexpr int kPieceFields = P_F0 + kMaxFactors * F_FIELDS;

struct Div {
  uint32_t mul, shift, d;
};

// n / d for n < 2^31 (PyTorch's IntDivider: mul = 2^32 (2^shift - d) / d + 1)
__device__ __forceinline__ uint32_t divide(uint32_t n, Div v) {
  return (__umulhi(n, v.mul) + n) >> v.shift;
}

struct Factor {
  const float* vec;  // this client's vector
  Div stride, dim;
};

__device__ __forceinline__ uint32_t factor_index(const Factor& f,
                                                 uint32_t col) {
  const uint32_t q = divide(col, f.stride);
  return q - divide(q, f.dim) * f.dim.d;
}

__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// clamp(round(v / safe), -127, 127), round half to even; inv = fl(1/safe)
__device__ __forceinline__ float quantize(float v, float safe, float inv) {
  const float t = __fmul_rn(v, inv);
  float k = rintf(t);
  if (!(fabsf(fabsf(__fsub_rn(t, k)) - 0.5f) > kNearHalf) ||
      !(fabsf(t) < 256.f))
    k = rintf(__fdiv_rn(v, safe));
  return fminf(fmaxf(k, -127.f), 127.f);
}

__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

// one element's y, q, e, e_q; the running max of step 1 (|y|) or 2 (|e|)
template <int STEP, typename Q>
struct Elem;

// a tile's scales: s = max * fl(1/127), safe = s or 1 where max is 0,
// inv = fl(1/safe)
struct Scale {
  float s, safe, inv;
};

__device__ __forceinline__ Scale scale_of(float mx) {
  Scale r;
  r.s = __fmul_rn(mx, kInv127);
  r.safe = mx > 0.f ? r.s : 1.f;
  r.inv = __frcp_rn(r.safe);
  return r;
}

template <int STEP>
struct Elem<STEP, int8_t> {
  static __device__ __forceinline__ void run(float y, const Scale& sy,
                                             const Scale& se, uint32_t& mx,
                                             int8_t& q_out, int8_t& e_out) {
    if (STEP == 1) {
      mx = max(mx, abs_bits(y));
      return;
    }
    const float q = quantize(y, sy.safe, sy.inv);
    const float e = __fsub_rn(y, __fmul_rn(q, sy.s));
    if (STEP == 2) {
      mx = max(mx, abs_bits(e));
      return;
    }
    q_out = (int8_t)__float2int_rn(q);
    e_out = (int8_t)__float2int_rn(quantize(e, se.safe, se.inv));
  }
};

template <int STEP>
struct Elem<STEP, __nv_bfloat16> {
  static __device__ __forceinline__ void run(float y, const Scale&,
                                             const Scale&, uint32_t&,
                                             __nv_bfloat16& q_out,
                                             __nv_bfloat16& e_out) {
    q_out = __float2bfloat16_rn(y);
    e_out = __float2bfloat16_rn(__fsub_rn(y, __bfloat162float(q_out)));
  }
};

__device__ __forceinline__ void store4(int8_t* p, const int8_t* v) {
  *reinterpret_cast<char4*>(p) = make_char4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const __nv_bfloat16* v) {
  __nv_bfloat162 a, b;
  a.x = v[0];
  a.y = v[1];
  b.x = v[2];
  b.y = v[3];
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// the block's max of v (valid in thread 0); red holds a value per warp
__device__ __forceinline__ uint32_t block_max(uint32_t v, uint32_t* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1)
      v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  __syncthreads();
  return v;
}

template <int STEP, typename Q>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
quant_admit_pass(const float* __restrict__ x, int64_t ldx,
                 const int64_t* __restrict__ gmaps, int64_t ldg, int graft,
                 const float* __restrict__ fac, int64_t ldf, Q* eq,
                 const float* __restrict__ es, Q* xq, int64_t ldq,
                 float* ymax, float* emax, int S,
                 const int64_t* __restrict__ pieces,
                 const int* __restrict__ tiles, int64_t ntiles, int m,
                 int vec_ok) {
  __shared__ uint32_t red[kThreads / 32];
  const int64_t work = ntiles * m;
  for (int64_t w = blockIdx.x; w < work; w += gridDim.x) {
    const int c = (int)(w % m);
    const int4 tl = reinterpret_cast<const int4*>(tiles)[w / m];
    const int64_t* P = pieces + (int64_t)tl.x * kPieceFields;
    const int u = tl.y, t0 = tl.z, len = tl.w;
    const int64_t rest = P[P_REST];
    const int64_t j = P[P_J0] + u;
    const int s = (int)(P[P_SEG0] + u);
    const int64_t src = (graft && P[P_STAGE0]) ? gmaps[c * ldg + j] : j;
    const uint32_t col0 = (uint32_t)(P[P_C0] + t0);  // column in the row
    const float* xr = x + c * ldx + P[P_XOFF] + src * P[P_ROWLEN] + col0;
    const int64_t qoff = c * ldq + P[P_A] + (int64_t)u * rest + t0;
    Q* eqr = eq + qoff;
    Q* xqr = xq + qoff;
    const float esc = es[c * S + s];
    Scale sy = {0.f, 1.f, 1.f}, se = {0.f, 1.f, 1.f};
    if (STEP >= 2 && ymax != nullptr) sy = scale_of(ymax[c * S + s]);
    if (STEP == 3 && emax != nullptr) se = scale_of(emax[c * S + s]);
    const int nf = (int)P[P_NF];
    Factor f[kMaxFactors];
#pragma unroll
    for (int k = 0; k < kMaxFactors; ++k) {
      if (k < nf) {
        const int64_t* F = P + P_F0 + k * F_FIELDS;
        f[k].vec = fac + c * ldf + F[F_COL];
        f[k].stride = {(uint32_t)F[F_SMUL], (uint32_t)F[F_SSHIFT],
                       (uint32_t)F[F_SD]};
        f[k].dim = {(uint32_t)F[F_DMUL], (uint32_t)F[F_DSHIFT],
                    (uint32_t)F[F_DD]};
      }
    }
    uint32_t mx = 0u;
    if (vec_ok && P[P_VEC]) {
      for (int base = 0; base < len; base += kChunk) {
        float4 xv[kUnroll], ev[kUnroll];
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const int t = base + (i * kThreads + (int)threadIdx.x) * 4;
          if (t < len) {
            xv[i] = *reinterpret_cast<const float4*>(xr + t);
            ev[i] = load4(eqr + t);
          }
        }
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const int t = base + (i * kThreads + (int)threadIdx.x) * 4;
          if (t >= len) continue;
          float y[4] = {__fadd_rn(xv[i].x, __fmul_rn(ev[i].x, esc)),
                        __fadd_rn(xv[i].y, __fmul_rn(ev[i].y, esc)),
                        __fadd_rn(xv[i].z, __fmul_rn(ev[i].z, esc)),
                        __fadd_rn(xv[i].w, __fmul_rn(ev[i].w, esc))};
          if (nf > 0) {
            float d[4];
#pragma unroll
            for (int k = 0; k < kMaxFactors; ++k) {
              if (k >= nf) break;
              float v[4];
              if (f[k].stride.d == 1) {
                // 4 neighbours along the factor's own axis (dim % 4 == 0)
                const float4 g = *reinterpret_cast<const float4*>(
                    f[k].vec + factor_index(f[k], col0 + t));
                v[0] = g.x;
                v[1] = g.y;
                v[2] = g.z;
                v[3] = g.w;
              } else {
                // stride % 4 == 0: the 4 share one index
                v[0] = v[1] = v[2] = v[3] =
                    f[k].vec[factor_index(f[k], col0 + t)];
              }
#pragma unroll
              for (int e = 0; e < 4; ++e)
                d[e] = k == 0 ? v[e] : __fmul_rn(d[e], v[e]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) y[e] = __fmul_rn(y[e], d[e]);
          }
          Q qo[4], eo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            Elem<STEP, Q>::run(y[e], sy, se, mx, qo[e], eo[e]);
          if (STEP == 3) {
            store4(xqr + t, qo);
            store4(eqr + t, eo);
          }
        }
      }
    } else {
      for (int t = threadIdx.x; t < len; t += kThreads) {
        float y = __fadd_rn(xr[t], __fmul_rn(to_f32(eqr[t]), esc));
        if (nf > 0) {
          float d = 1.f;
#pragma unroll
          for (int k = 0; k < kMaxFactors; ++k) {
            if (k >= nf) break;
            const float v = f[k].vec[factor_index(f[k], col0 + t)];
            d = k == 0 ? v : __fmul_rn(d, v);
          }
          y = __fmul_rn(y, d);
        }
        Q qo, eo;
        Elem<STEP, Q>::run(y, sy, se, mx, qo, eo);
        if (STEP == 3) {
          xqr[t] = qo;
          eqr[t] = eo;
        }
      }
    }
    if (STEP < 3) {
      mx = block_max(mx, red);
      float* table = STEP == 1 ? ymax : emax;
      if (threadIdx.x == 0 && mx != 0u)
        atomicMax(reinterpret_cast<unsigned int*>(table + c * S + s), mx);
    }
  }
}

template <int STEP, typename Q>
int launch(const float* x, int64_t ldx, const int64_t* gmaps, int64_t ldg,
           int graft, const float* fac, int64_t ldf, void* eq,
           const float* es, void* xq, int64_t ldq, float* ymax, float* emax,
           int S, const int64_t* pieces, const int* tiles, int64_t ntiles,
           int m, int vec_ok, int sms, cudaStream_t stream) {
  int64_t blocks = ntiles * m;
  const int64_t cap = (int64_t)sms * 8;
  if (blocks > cap) blocks = cap;
  quant_admit_pass<STEP, Q><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, ldx, gmaps, ldg, graft, fac, ldf, (Q*)eq, es, (Q*)xq, ldq, ymax,
      emax, S, pieces, tiles, ntiles, m, vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace

// step 1, 2 or 3 of an int8 admission (dtype 1), or step 3 of a bf16 one
// (dtype 2); tile_elems must equal kTile, which the wrapper cut the tiles by
extern "C" int quant_admit(int step, int dtype, const float* x, int64_t ldx,
                           const int64_t* gmaps, int64_t ldg, int graft,
                           const float* fac, int64_t ldf, void* eq,
                           const float* es, void* xq, int64_t ldq,
                           float* ymax, float* emax, int S,
                           const int64_t* pieces, const int* tiles,
                           int64_t ntiles, int m, int vec_ok, int tile_elems,
                           int sms, void* stream) {
  if (tile_elems != kTile) return (int)cudaErrorInvalidValue;
  if (ntiles == 0 || m == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (step == 1)
      return launch<1, int8_t>(x, ldx, gmaps, ldg, graft, fac, ldf, eq, es,
                               xq, ldq, ymax, emax, S, pieces, tiles, ntiles,
                               m, vec_ok, sms, s);
    if (step == 2)
      return launch<2, int8_t>(x, ldx, gmaps, ldg, graft, fac, ldf, eq, es,
                               xq, ldq, ymax, emax, S, pieces, tiles, ntiles,
                               m, vec_ok, sms, s);
    if (step == 3)
      return launch<3, int8_t>(x, ldx, gmaps, ldg, graft, fac, ldf, eq, es,
                               xq, ldq, ymax, emax, S, pieces, tiles, ntiles,
                               m, vec_ok, sms, s);
  }
  if (dtype == 2 && step == 3)
    return launch<3, __nv_bfloat16>(x, ldx, gmaps, ldg, graft, fac, ldf, eq,
                                    es, xq, ldq, ymax, emax, S, pieces, tiles,
                                    ntiles, m, vec_ok, sms, s);
  return (int)cudaErrorInvalidValue;
}
