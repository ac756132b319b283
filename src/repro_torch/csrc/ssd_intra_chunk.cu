// ssd_intra_chunk: the intra-chunk term of Mamba-2's chunked SSD.  For each
// chunk g and head h (Q positions, head width hp, state width N):
//   la = dt * A;  L = cumsum(la)
//   M[t, s] = (C_t . B_s) * exp(L_t - L_s) * dt_s   for s <= t, else 0
//   y = M x                                         (Q, hp)
//   state = x^T (B * dt * exp(L_{Q-1} - L))         (hp, N)
// and L itself, all f32, in the TPU kernel's layouts: y (G, Q, nh, hp),
// state (G, nh, hp, N), L (G, Q, nh).
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::ssd_intra_chunk
// (_ssd_kernel).  Bound on the H100: operations -- per chunk Q*Q*N
// multiply-adds for C B^T and per (chunk, head) Q*Q*hp for M x and
// Q*hp*N for the state, against about 4 bytes read or written per
// Q*hp/4 of them; at the f32 rate of the CUDA cores.
//
// Design: B and C are shared by every head (one group), so a block takes
// one chunk and a group of `hg` heads (the wrapper picks hg so the grid
// fills the SMs in as few waves as it can) and forms C B^T once, in shared
// memory, for all of them.  Shared memory (f32, at Q = N = 128, hp = 64,
// 199 KB of the 227 KB a block may take): B (Q x N+4), C B^T transposed
// (Q x Q+1), and one region that holds C while C B^T is formed and then a
// head's x (Q x hp) and one 64-row tile of M^T (Q x 64) -- M is built and
// used a tile of t at a time, so it never needs the whole Q x Q.  The three
// products are register-tiled f32 FMAs on the CUDA cores (no tensor cores:
// TF32 would change the numerics against the reference).  Row strides of
// B and C are padded by 4 floats and C B^T's by 1 so the strided reads and
// the transposed writes fall in distinct banks.
//
// L is summed in the order the reference's CPU code sums a cumulative sum
// (tiles of 16, see cumsum_like_xla), which the plain version follows too,
// so the kernel's L has the plain version's bits.  The exponent is formed
// only for s <= t (above the diagonal L_t - L_s > 0 could overflow, and
// inf * 0 is NaN); __fmul_rn keeps dt * A from being contracted into the
// first add; there is no fast math: expf, not __expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
constexpr int kMaxHp = 64;
constexpr int kTile = 64;  // rows of t per tile of M

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_intra_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ B,
                       const T* __restrict__ C, float* __restrict__ y,
                       float* __restrict__ state, float* __restrict__ Lout,
                       int Q, int nh, int hp, int N, int hg) {
  extern __shared__ __align__(16) float smem[];
  const int ldn = N + 4, ldq = Q + 1, tile = min(Q, kTile);
  const int r1 = max(Q * ldn, Q * hp + Q * tile);
  float* Bs = smem;          // (Q, ldn)
  float* Cs = Bs + Q * ldn;  // (Q, ldn), then xs and MT
  float* xs = Cs;            // (Q, hp)
  float* MT = Cs + Q * hp;   // (Q, tile): M^T of one tile of t
  float* CBT = Cs + r1;      // (Q, ldq): CBT[s][t] = C_t . B_s
  float* Ls = CBT + Q * ldq; // (Q,): la, then L
  float* pre = Ls + Q;       // (Q / 16 + 1,): scan scratch
  float* dts = Ls + 2 * Q;   // (Q,)
  float* wts = dts + Q;      // (Q,): dt_s * exp(L_{Q-1} - L_s)

  const int g = blockIdx.x, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  const T* Bg = B + (size_t)g * Q * N;
  const T* Cg = C + (size_t)g * Q * N;
  for (int i = tid; i < Q * N; i += kThreads) {
    const int r = i / N, c = i - r * N;
    Bs[r * ldn + c] = to_f32(Bg[i]);
    Cs[r * ldn + c] = to_f32(Cg[i]);
  }
  __syncthreads();

  // C B^T: thread (ty, tx) owns t = ty + 16 i, s = tx + 16 j, 8 x 8
  {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int n = 0; n < N; n += 4) {
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i, s = tx + 16 * i;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        a[i] = t < Q ? ld4(Cs + t * ldn + n) : z;
        b[i] = s < Q ? ld4(Bs + s * ldn + n) : z;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = ty + 16 * i, s = tx + 16 * j;
        if (t < Q && s < Q) CBT[s * ldq + t] = acc[i][j];
      }
  }
  __syncthreads();  // C is dead: its region now holds xs and MT

  for (int hh = 0; hh < hg; ++hh) {
    const int h = blockIdx.y * hg + hh;
    const float Ah = A[h];
    for (int i = tid; i < Q; i += kThreads) {
      const float d = dt[((size_t)g * Q + i) * nh + h];
      dts[i] = d;
      Ls[i] = __fmul_rn(d, Ah);
    }
    for (int i = tid; i < Q * hp; i += kThreads) {
      const int s = i / hp, p = i - s * hp;
      xs[i] = to_f32(x[(((size_t)g * Q + s) * nh + h) * hp + p]);
    }
    __syncthreads();
    cumsum_like_xla(Ls, Q, pre);
    for (int i = tid; i < Q; i += kThreads) {
      Lout[((size_t)g * Q + i) * nh + h] = Ls[i];
      wts[i] = dts[i] * expf(Ls[Q - 1] - Ls[i]);
    }
    __syncthreads();

    // y, one tile of t at a time (rows s >= t0 + tile of M^T are zero)
    for (int t0 = 0; t0 < Q; t0 += tile) {
      const int smax = min(Q, t0 + tile);
      for (int i = tid; i < smax * tile; i += kThreads) {
        const int s = i / tile, tt = i - s * tile, t = t0 + tt;
        float m = 0.f;
        if (s <= t && t < Q) {
          m = CBT[s * ldq + t] * expf(Ls[t] - Ls[s]);
          m = m * dts[s];
        }
        MT[s * tile + tt] = m;
      }
      __syncthreads();
      if (4 * ty < tile && 4 * tx < hp) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int s = 0; s < smax; ++s) {
          const float4 a = ld4(MT + s * tile + 4 * ty);
          const float4 b = ld4(xs + s * hp + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(comp(a, i), comp(b, j), acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + 4 * ty + i;
          if (t >= Q) break;
          float* dst = y + (((size_t)g * Q + t) * nh + h) * hp + 4 * tx;
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
      __syncthreads();
    }

    // state[p][n] = sum_s x[s][p] * (B[s][n] * w_s): p = 4 ty + i,
    // n = 4 tx + 64 k + j
    if (4 * ty < hp) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      const bool lo_ok = 4 * tx < N, hi_ok = 4 * tx + 64 < N;
      for (int s = 0; s < Q; ++s) {
        const float w = wts[s];
        const float4 a = ld4(xs + s * hp + 4 * ty);
        float4 b0 = lo_ok ? ld4(Bs + s * ldn + 4 * tx)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        float4 b1 = hi_ok ? ld4(Bs + s * ldn + 4 * tx + 64)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        float b[8] = {b0.x * w, b0.y * w, b0.z * w, b0.w * w,
                      b1.x * w, b1.y * w, b1.z * w, b1.w * w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(comp(a, i), b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* row = state + (((size_t)g * nh + h) * hp + 4 * ty + i) * N;
        if (lo_ok)
          *reinterpret_cast<float4*>(row + 4 * tx) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (hi_ok)
          *reinterpret_cast<float4*>(row + 4 * tx + 64) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
    __syncthreads();  // before the next head overwrites xs, dts, Ls
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* state,
                   void* L, int G, int Q, int nh, int hp, int N, int hg,
                   size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
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
// Q <= 128, N <= 128, hp <= 64, each a multiple of 4, and hg dividing nh.
extern "C" int ssd_intra_chunk(const void* x, int dtype, const void* dt,
                               const void* A, const void* B, const void* C,
                               void* y, void* state, void* L, int G, int Q,
                               int nh, int hp, int N, int hg, void* stream) {
  if (G < 1 || Q < 4 || Q > kMaxQ || N < 4 || N > kMaxN || hp < 4 ||
      hp > kMaxHp || Q % 4 || N % 4 || hp % 4 || hg < 1 || nh % hg)
    return (int)cudaErrorInvalidValue;
  const int tile = Q < kTile ? Q : kTile;
  const int r1 = Q * (N + 4) > Q * hp + Q * tile ? Q * (N + 4)
                                                  : Q * hp + Q * tile;
  const size_t bytes =
      sizeof(float) * ((size_t)Q * (N + 4) + r1 + (size_t)Q * (Q + 1) + 4 * Q);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, dt, A, B, C, y, state, L, G, Q, nh, hp, N,
                              hg, bytes, s);
  if (dtype == 2)
    return (int)launch<__nv_bfloat16>(x, dt, A, B, C, y, state, L, G, Q, nh,
                                      hp, N, hg, bytes, s);
  return (int)cudaErrorInvalidValue;
}
