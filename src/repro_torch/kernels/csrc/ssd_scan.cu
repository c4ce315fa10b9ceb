// Chunked SSD scan (Mamba-2 state-space duality) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:_kernel
// (launched by ssd_scan, :72).  For each (row b, head h) it walks the
// sequence in chunks of Q positions, carrying an f32 state S (N x P):
//
//   cum    = cumsum(a) over the chunk
//   y_i    = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) C_i . S_prev
//   S_new  = exp(cum_last) S_prev + sum_j B_j^T exp(cum_last - cum_j) dt_j x_j
//
// x (B, S, H, P) in f32 or bf16, B_ and C_ (B, S, N) in x's dtype (one group
// shared by every head), dt and a (B, S, H) in f32.  Everything is computed
// in f32 but the chunk's cumsum of a, kept in f64 (see below); y is written
// in the dtype asked for (x's, or f32 as the model's ssm_apply needs), the
// final state (B, H, N, P) in f32.  The ragged last
// chunk is masked: that equals the reference's padding with a = 0 and
// x = 0 (src/repro/kernels/ops.py:66-78), which leaves the state as it was.
// The plain PyTorch version is src/repro_torch/kernels/ref.py:ssd_reference
// (the exact sequential recurrence).
//
// What bounds it on an H100.  Per chunk of 256 with N = 128, P = 64 the
// four products (C B^T over the causal half, its product with x, C S_prev
// and B^T x) take ~24 MFLOP against ~100 KB of input, so at mamba2_370m's
// prefill it is bound by operations; with f32 FMAs on the CUDA cores it
// stays well above the bf16 tensor-core bound.
//
// What the design does.
// (1) The Pallas grid (B, H, S/Q) walks chunks as its sequential last axis
//     with the state in VMEM.  Here one CTA per (row, head) loops over the
//     chunks and keeps the state in shared memory (N x P f32, 32 KB).  A
//     chunk-parallel design (states first, then the outputs) is later work.
// (2) The chunk's working set does not fit one block's 227 KB at Q = 256
//     (L alone is 256 KB in f32): the quadratic term is tiled into 64 x 64
//     blocks of (query rows i, key rows j), blocks above the diagonal are
//     skipped, and C_i B_j^T and L are computed on the fly from cum; L is
//     never stored.
// (3) The state update reuses each diagonal block's B_j and x_j tiles
//     while they are in shared memory, accumulating B^T (decay dt x) in
//     registers; the state in shared memory is updated only after every
//     row of the chunk has read S_prev.
// (4) B_ and C_ are shared by all heads, so the CTAs of one row re-read
//     them; L2 (50 MB) holds them.
// (5) Register tiles: thread (tr, tc) of 16 x 16 computes scores for rows
//     tr*4.. and keys tc + 16j from float4 reads of B and C rows padded to
//     N + 4 floats (conflict-free for N a multiple of 8); outputs for p =
//     tc + 16j; state elements n = tr + 16a, p = tc + 16j.
//
// The entry point returns cudaGetLastError() (or the first error of a
// runtime call) as an int; the Python wrapper raises when it is non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlk = 64;              // rows of a (query or key) block
constexpr int kMaxChunk = kThreads;   // one thread per position for the cumsum
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kMaxA = kMaxN / 16;     // state rows a thread
constexpr int kMaxJ = kMaxP / 16;     // output / state columns a thread
constexpr int kLdg = kBlk + 4;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// kBlk rows of `width` elements (row r at src + r * stride) into a shared
// f32 tile with row stride ld, each element times mul(r); rows with
// r >= n_valid are zero-filled.
template <typename T, typename Mul>
__device__ __forceinline__ void stage(float* dst, int n_valid, int width, int ld, size_t stride,
                                      Mul mul, const T* src) {
  constexpr int vec = 16 / sizeof(T);
  const int per_row = width / vec;
  for (int i = threadIdx.x; i < kBlk * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * vec;
    float tmp[vec];
    if (r < n_valid) {
      load16(src + r * stride + c, tmp);
      const float f = mul(r);
#pragma unroll
      for (int e = 0; e < vec; ++e) tmp[e] *= f;
    } else {
#pragma unroll
      for (int e = 0; e < vec; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < vec; ++e) dst[r * ld + c + e] = tmp[e];
  }
}

size_t smem_bytes(int N, int P) {
  return (kMaxChunk + 32) * sizeof(double) +
         ((size_t)N * P + kMaxChunk + 2 * (size_t)kBlk * (N + 4) + (size_t)kBlk * P +
          (size_t)kBlk * kLdg) *
             sizeof(float);
}

// grid (H, B), kThreads threads.
template <typename T, typename TY>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_fwd(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
             const T* __restrict__ Bm, const T* __restrict__ Cm, TY* __restrict__ y,
             float* __restrict__ state_out, int S, int H, int P, int N, int chunk) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int ldn = N + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum_s = reinterpret_cast<double*>(smem);  // (kMaxChunk,)
  double* warp_s = cum_s + kMaxChunk;               // (32,) scan carries
  float* st_s = reinterpret_cast<float*>(warp_s + 32);  // (N, P) the state
  float* dt_s = st_s + N * P;                     // (kMaxChunk,)
  float* c_s = dt_s + kMaxChunk;                  // (kBlk, ldn) C rows of block i
  float* b_s = c_s + kBlk * ldn;                  // (kBlk, ldn) B rows of block j
  float* x_s = b_s + kBlk * ldn;                  // (kBlk, P) dt * x rows of block j
  float* g_s = x_s + kBlk * P;                    // (kBlk, kLdg) masked C B^T L

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int jp = (P + 15) / 16, an = (N + 15) / 16;
  for (int i = tid; i < N * P; i += kThreads) st_s[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int len = min(chunk, S - c0);
    // cum = inclusive cumsum of a over the chunk (a = 0 past its end), in
    // f64: every decay is exp(cum_i - cum_j), and at Q = 256 |cum| reaches
    // hundreds, where an f32 difference of two sums would lose ~1e-5 of
    // the exponent; the difference is taken in f64, the exp in f32
    {
      const size_t off = ((size_t)b * S + c0 + tid) * H + h;
      double av = tid < len ? (double)a[off] : 0.0;
      dt_s[tid] = tid < len ? dt[off] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double n = __shfl_up_sync(0xffffffffu, av, o);
        if (lane >= o) av += n;
      }
      if (lane == 31) warp_s[warp] = av;
      __syncthreads();
      if (warp == 0) {
        double w = lane < kThreads / 32 ? warp_s[lane] : 0.0;
#pragma unroll
        for (int o = 1; o < kThreads / 32; o <<= 1) {
          const double n = __shfl_up_sync(0xffffffffu, w, o);
          if (lane >= o) w += n;
        }
        if (lane < kThreads / 32) warp_s[lane] = w;
      }
      __syncthreads();
      if (warp > 0) av += warp_s[warp - 1];
      cum_s[tid] = av;
      __syncthreads();
    }
    const double cum_last = cum_s[len - 1];
    const int nb = (len + kBlk - 1) / kBlk;
    float sacc[kMaxA][kMaxJ];
#pragma unroll
    for (int q = 0; q < kMaxA; ++q)
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) sacc[q][j] = 0.f;

    for (int ib = 0; ib < nb; ++ib) {
      const int i0 = ib * kBlk;
      stage<T>(c_s, len - i0, N, ldn, N, [](int) { return 1.f; },
               Cm + ((size_t)b * S + c0 + i0) * N);
      __syncthreads();
      // y_acc = exp(cum_i) * C_i . S_prev
      float yacc[4][kMaxJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) yacc[i][j] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = *reinterpret_cast<const float4*>(c_s + (tr * 4 + i) * ldn + n);
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          const int p = tc + 16 * j;
          if (j < jp && p < P) {
            const float s0 = st_s[n * P + p], s1 = st_s[(n + 1) * P + p];
            const float s2 = st_s[(n + 2) * P + p], s3 = st_s[(n + 3) * P + p];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              yacc[i][j] += cv[i].x * s0 + cv[i].y * s1 + cv[i].z * s2 + cv[i].w * s3;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf((float)cum_s[min(i0 + tr * 4 + i, len - 1)]);
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) yacc[i][j] *= e;
      }

      for (int jb = 0; jb <= ib; ++jb) {
        const int j0 = jb * kBlk;
        stage<T>(b_s, len - j0, N, ldn, N, [](int) { return 1.f; },
                 Bm + ((size_t)b * S + c0 + j0) * N);
        stage<T>(x_s, len - j0, P, P, (size_t)H * P, [&](int r) { return dt_s[j0 + r]; },
                 x + (((size_t)b * S + c0 + j0) * H + h) * P);
        __syncthreads();
        // g[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i < len
        {
          float s[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
          for (int n = 0; n < N; n += 4) {
            float4 cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = *reinterpret_cast<const float4*>(c_s + (tr * 4 + i) * ldn + n);
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b_s + (tc + 16 * j) * ldn + n);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                s[i][j] += cv[i].x * bv[j].x + cv[i].y * bv[j].y + cv[i].z * bv[j].z + cv[i].w * bv[j].w;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int gi = i0 + tr * 4 + i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int gj = j0 + tc + 16 * j;
              const bool ok = gi < len && gj <= gi;
              g_s[(tr * 4 + i) * kLdg + tc + 16 * j] =
                  ok ? s[i][j] * expf((float)(cum_s[gi] - cum_s[gj])) : 0.f;
            }
          }
        }
        __syncthreads();
        // y_acc += g . x_j
        for (int kk = 0; kk < kBlk; kk += 4) {
          float4 gv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = *reinterpret_cast<const float4*>(g_s + (tr * 4 + i) * kLdg + kk);
#pragma unroll
          for (int j = 0; j < kMaxJ; ++j) {
            const int p = tc + 16 * j;
            if (j < jp && p < P) {
              const float x0 = x_s[kk * P + p], x1 = x_s[(kk + 1) * P + p];
              const float x2 = x_s[(kk + 2) * P + p], x3 = x_s[(kk + 3) * P + p];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                yacc[i][j] += gv[i].x * x0 + gv[i].y * x1 + gv[i].z * x2 + gv[i].w * x3;
            }
          }
        }
        if (jb == ib) {
          // state: sacc[n][p] += sum_t B_t[n] exp(cum_last - cum_t) dt_t x_t[p]
          const int nt = min(kBlk, len - j0);
          for (int t = 0; t < nt; ++t) {
            const float w = expf((float)(cum_last - cum_s[j0 + t]));
#pragma unroll
            for (int q = 0; q < kMaxA; ++q) {
              const int n = tr + 16 * q;
              if (q < an && n < N) {
                const float bn = b_s[t * ldn + n] * w;
#pragma unroll
                for (int j = 0; j < kMaxJ; ++j) {
                  const int p = tc + 16 * j;
                  if (j < jp && p < P) sacc[q][j] += bn * x_s[t * P + p];
                }
              }
            }
          }
        }
        __syncthreads();  // b_s, x_s and g_s are overwritten next
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = i0 + tr * 4 + i;
        if (gi >= len) continue;
        TY* yr = y + (((size_t)b * S + c0 + gi) * H + h) * P;
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          const int p = tc + 16 * j;
          if (j < jp && p < P) yr[p] = from_f32<TY>(yacc[i][j]);
        }
      }
    }

    // S <- exp(cum_last) S_prev + sacc: every row of the chunk has read S_prev
    const float decay = expf((float)cum_last);
#pragma unroll
    for (int q = 0; q < kMaxA; ++q) {
      const int n = tr + 16 * q;
      if (q < an && n < N) {
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          const int p = tc + 16 * j;
          if (j < jp && p < P) st_s[n * P + p] = decay * st_s[n * P + p] + sacc[q][j];
        }
      }
    }
    __syncthreads();
  }

  float* so = state_out + ((size_t)b * H + h) * N * P;
  for (int i = tid; i < N * P; i += kThreads) so[i] = st_s[i];
}

template <typename T, typename TY>
int launch(const void* x, const float* dt, const float* a, const void* Bm, const void* Cm, void* y,
           float* state, int B, int S, int H, int P, int N, int chunk, cudaStream_t stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(N, P);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_fwd<T, TY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_fwd<T, TY><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<TY*>(y), state, S, H, P, N, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  x, B_ and C_ share x's dtype;
// y is written in y's; dt, a and the state are f32.  Shapes: x, y
// (B, S, H, P); dt, a (B, S, H); B_, C_ (B, S, N); state (B, H, N, P); all
// contiguous and 16-byte aligned.  N and P multiples of 8, N <= 128,
// P <= 64, 1 <= chunk <= 256.
int ssd_scan(int x_dtype, int y_dtype, const void* x, const float* dt, const float* a,
             const void* Bm, const void* Cm, void* y, float* state, int B, int S, int H, int P,
             int N, int chunk, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N < 8 || N % 8 != 0 || N > kMaxN || P < 8 || P % 8 != 0 || P > kMaxP || chunk < 1 ||
      chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
#define SSD_CASE(T, TY) return launch<T, TY>(x, dt, a, Bm, Cm, y, state, B, S, H, P, N, chunk, st)
  if (x_dtype == 0 && y_dtype == 0) SSD_CASE(float, float);
  if (x_dtype == 1 && y_dtype == 1) SSD_CASE(__nv_bfloat16, __nv_bfloat16);
  if (x_dtype == 1 && y_dtype == 0) SSD_CASE(__nv_bfloat16, float);
  if (x_dtype == 0 && y_dtype == 1) SSD_CASE(float, __nv_bfloat16);
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
