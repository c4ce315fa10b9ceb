// Chunked SSD scan (Mamba-2 state-space duality) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:_kernel
// (launched by ssd_scan, :72).  For each (row b, head h) the sequence goes
// in chunks of Q positions, with an f32 state S (N x P) carried across them:
//
//   cum    = cumsum(a) over the chunk
//   y_i    = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) C_i . S_prev
//   S_new  = exp(cum_last) S_prev + sum_j B_j^T exp(cum_last - cum_j) dt_j x_j
//
// x (B, S, H, P) in f32 or bf16, B_ and C_ (B, S, N) in x's dtype (one group
// shared by every head), dt and a (B, S, H) in f32.  Everything is computed
// in f32 but the chunk's cumsum of a, kept in f64: every decay is
// exp(cum_i - cum_j), and at Q = 256 |cum| reaches hundreds, where an f32
// difference of two sums would lose ~1e-5 of the exponent; the difference
// is taken in f64, the exp in f32.  y is written in the dtype asked for
// (x's, or f32 as the model's ssm_apply needs), the final state (B, H, N, P)
// in f32.  The ragged last chunk is masked: that equals the reference's
// padding with a = 0 and x = 0 (src/repro/kernels/ops.py:66-78), which
// leaves the state as it was.  The plain PyTorch version is
// src/repro_torch/kernels/ref.py:ssd_reference (the exact sequential
// recurrence).
//
// What bounds it on an H100.  At mamba2_370m's prefill (8 x 4096, 32 heads,
// P 64, N 128, Q 256) the inputs and outputs are 0.44 GB (0.13 ms at
// 3.35 TB/s) against ~53 GFLOP of products: 0.79 ms on the f32 CUDA cores,
// 0.05 ms on the bf16 tensor cores.  So on FMAs it is bound by operations,
// and only tensor cores bring it near its bytes.
//
// Two variants, chosen by the dtype of x.
//
// bf16 x (the model's path): chunk-parallel, tensor cores, three kernels
// launched by one call (the decomposition of the reference's ssd_chunked,
// src/repro/models/ssm.py:52-91):
//   ssd_scan_states  grid (H, chunks, B): the chunk's own state
//                    B^T (w * x), w_j = exp(cum_last - cum_j) dt_j, into an
//                    f32 buffer (B, chunks, H, N, P) -- 134 MB at mamba's
//                    prefill -- and its decay exp(cum_last) into (B, chunks, H);
//   ssd_scan_carry   grid (N*P/1024, H, B): walks the chunks of each state
//                    element, S <- decay S + own, and leaves in the buffer
//                    the state BEFORE each chunk; writes the final state;
//   ssd_scan_out     grid (H, chunks, B): y = ((C B^T) o L o dt) x
//                    + exp(cum) (C S_prev).
// The first and third give B * chunks * H independent CTAs (4,096 at
// mamba's prefill), where a walk over the chunks in one CTA per (row, head)
// gave 256.  Each stages its chunk in shared memory with cp.async (B_, C_,
// x; the state through registers) and multiplies with mma.sync.m16n8k16,
// bf16 operands, f32 accumulation; each warp owns 16-row tiles of the
// output.  Products:
//   C B^T               raw bf16 operands: exact products;
//   G = (C B^T) o L o dt times x:  x raw bf16, G (f32) split into
//                       hi = bf16(G) and lo = bf16(G - hi), two products;
//   C S_prev            C raw, S_prev (f32) split hi + lo; exp(cum_i) scales
//                       the rows after the product;
//   B^T (w o x)         x raw, w o B^T (f32, w applied in registers) split
//                       hi + lo.
// A split keeps an operand to ~2^-17 of itself, where one rounding to bf16
// would cost up to 2^-9 (tools/prefill_accuracy.py measures both at the model's
// inputs).  In the third kernel G never leaves registers: the accumulator
// of C B^T for 16 rows x 16 keys is, element for element, the A operand of
// the next product (as P is in flash attention).
//
// f32 x (the float32 paths, y held to 1e-4): the first version of this
// kernel, ssd_scan_fwd, on FMAs -- one CTA per (row, head) walks the chunks
// with the state in shared memory (N x P f32), the quadratic term in
// 64 x 64 blocks of (query rows i, key rows j), blocks above the diagonal
// skipped, C_i B_j^T and L computed on the fly, the state update reusing
// each diagonal block's B_j and x_j tiles.
//
// The entry point returns cudaGetLastError() (or the first error of a
// runtime call) as an int; the Python wrapper raises when it is non-zero.
// ssd_scan_kernels_launched() returns how many device kernels the library
// has launched so far, counted beside each launch: kernels per call
// without a tracer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

std::atomic<long long> g_kernels{0};  // device kernels launched

constexpr int kThreads = 256;
constexpr int kBlk = 64;              // rows of a (query or key) block
constexpr int kMaxChunk = kThreads;   // one thread per position for the cumsum
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kMaxA = kMaxN / 16;     // state rows a thread
constexpr int kMaxJ = kMaxP / 16;     // output / state columns a thread
constexpr int kLdg = kBlk + 4;
constexpr int kOutThreads = 512;      // ssd_scan_out: 16 warps, one 16-row tile each

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
  if ((err = cudaGetLastError()) == cudaSuccess) ++g_kernels;
  return (int)err;
}

// ------------------------------------------- chunk-parallel variant (bf16)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += a (16x16, row) * b (16x8, col): bf16 in, f32 accumulate.
// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// hi = bf16(x, y) and lo = bf16(x - hi, y - hi): a pair split in two
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// acc[n] += (hi + lo) * B for the n tiles of 8 columns below `ncols`: B (16
// rows x ncols) read transposed from shared memory at `b` (rows ld apart);
// every B tile is loaded, then the hi products issued, then the lo ones.
template <int NT>
__device__ __forceinline__ void mma_hi_lo(float (*acc)[4], const uint32_t hi[4],
                                          const uint32_t lo[4], const bf16* b, int ld,
                                          int ncols) {
  const int lane = threadIdx.x & 31;
  const bf16* at = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
  uint32_t bt[NT / 2][4];
#pragma unroll
  for (int n = 0; n < NT; n += 2)
    if (n * 8 < ncols) ldmatrix_x4_trans(bt[n / 2], at + n * 8);
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n * 8 < ncols) mma_bf16(acc[n], hi, bt[n / 2][(n & 1) * 2], bt[n / 2][(n & 1) * 2 + 1]);
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n * 8 < ncols) mma_bf16(acc[n], lo, bt[n / 2][(n & 1) * 2], bt[n / 2][(n & 1) * 2 + 1]);
}

// acc[n] += a * B for the n tiles of 8 columns below `ncols` (B as above).
template <int NT>
__device__ __forceinline__ void mma_rows(float (*acc)[4], const uint32_t a[4], const bf16* b,
                                         int ld, int ncols) {
  const int lane = threadIdx.x & 31;
  const bf16* at = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < NT; n += 2)
    if (n * 8 < ncols) {
      uint32_t bt[4];
      ldmatrix_x4_trans(bt, at + n * 8);
      mma_bf16(acc[n], a, bt[0], bt[1]);
      if ((n + 1) * 8 < ncols) mma_bf16(acc[n + 1], a, bt[2], bt[3]);
    }
}

// Two neighbouring outputs in one store.
__device__ __forceinline__ void store2(float* p, float u, float v) {
  *reinterpret_cast<float2*>(p) = make_float2(u, v);
}
__device__ __forceinline__ void store2(bf16* p, float u, float v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(u, v);
}

// Row length of a bf16 tile whose rows are read 16 columns at a time:
// the width rounded up to 16 (the columns past it are zero where a product
// sums over them), plus 8, so that rows are an odd number of 16-byte units
// apart and ldmatrix hits distinct banks.
__host__ __device__ inline int tile_ld(int width) { return ((width + 15) & ~15) + 8; }

// The chunk's inclusive cumsum of a in f64 (one thread a position, a = 0
// past len; a block of 256 or 512 threads) into cum_s (kMaxChunk);
// warp_s holds the warps' carries.
__device__ __forceinline__ void chunk_cumsum(const float* a, size_t at, size_t stride, int len,
                                             double* cum_s, double* warp_s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  double av = tid < len ? (double)a[at + tid * stride] : 0.0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, av, o);
    if (lane >= o) av += n;
  }
  if (lane == 31) warp_s[warp] = av;
  __syncthreads();
  if (warp == 0) {
    double w = lane < warps ? warp_s[lane] : 0.0;
    for (int o = 1; o < warps; o <<= 1) {
      const double n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    if (lane < warps) warp_s[lane] = w;
  }
  __syncthreads();
  if (warp > 0) av += warp_s[warp - 1];
  if (tid < kMaxChunk) cum_s[tid] = av;
}

// `rows` rows of `width` bf16 (row j at src + j * stride; rows >= len
// zero-filled) into a shared tile with row length ld, by cp.async; the
// columns from width up to a multiple of 16 are set to zero.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src, size_t stride,
                                           int rows, int len, int width) {
  const int vecs = width / 8;
  for (int e = threadIdx.x; e < rows * vecs; e += blockDim.x) {
    const int j = e / vecs, c = (e - j * vecs) * 8;
    cp_async16(dst + j * ld + c, src + (size_t)(j < len ? j : 0) * stride + c, j < len);
  }
  const int pad = ((width + 15) & ~15) - width;
  if (pad)
    for (int e = threadIdx.x; e < rows * pad; e += blockDim.x)
      dst[(e / pad) * ld + width + e % pad] = __float2bfloat16(0.f);
}

struct ChunkDims {
  int rows, ldn, ldp;  // rows = chunk rounded up to 16
  __host__ __device__ ChunkDims(int chunk, int N, int P)
      : rows((chunk + 15) & ~15), ldn(tile_ld(N)), ldp(tile_ld(P)) {}
  // shared bytes of ssd_scan_states: cum, carries, w, B (rows, ldn), x (rows, ldp)
  __host__ __device__ size_t states_bytes() const {
    return (kMaxChunk + 32) * sizeof(double) + rows * sizeof(float) +
           ((size_t)rows * ldn + (size_t)rows * ldp) * sizeof(bf16);
  }
  // shared bytes of ssd_scan_out: cum, carries, dt, C and B (rows, ldn),
  // x (rows, ldp), S_prev hi and lo (N rounded up to 16, ldp)
  __host__ __device__ size_t out_bytes(int N) const {
    return (kMaxChunk + 32) * sizeof(double) + rows * sizeof(float) +
           (2 * (size_t)rows * ldn + (size_t)rows * ldp + 2 * (size_t)((N + 15) & ~15) * ldp) *
               sizeof(bf16);
  }
};

// grid (H, chunks, B).  Warp w computes rows n = 16w .. 16w + 15 of the
// chunk's own state B^T (w o x) (N x P), over the chunk's positions: B and
// x land raw by cp.async; w is applied to the B^T tile in registers, which
// is then split into hi + lo.
__global__ void __launch_bounds__(kThreads)
ssd_scan_states(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const bf16* __restrict__ Bm, int S, int H, int P,
                int N, int chunk, float* __restrict__ states, float* __restrict__ decay) {
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int c0 = c * chunk, len = min(chunk, S - c0);
  const ChunkDims dim(chunk, N, P);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ __align__(128) unsigned char smem[];
  double* cum_s = reinterpret_cast<double*>(smem);
  double* warp_s = cum_s + kMaxChunk;
  float* w_s = reinterpret_cast<float*>(warp_s + 32);
  bf16* b_s = reinterpret_cast<bf16*>(w_s + dim.rows);
  bf16* x_s = b_s + dim.rows * dim.ldn;

  const size_t at = ((size_t)b * S + c0) * H + h;
  stage_rows(b_s, dim.ldn, Bm + ((size_t)b * S + c0) * N, N, dim.rows, len, N);
  stage_rows(x_s, dim.ldp, x + at * P, (size_t)H * P, dim.rows, len, P);
  cp_async_commit();
  chunk_cumsum(a, at, H, len, cum_s, warp_s);
  __syncthreads();
  const double cum_last = cum_s[len - 1];
  if (tid < dim.rows)
    w_s[tid] = tid < len ? expf((float)(cum_last - cum_s[tid])) * dt[at + (size_t)tid * H] : 0.f;
  if (tid == 0) decay[((size_t)b * nc + c) * H + h] = expf((float)cum_last);
  cp_async_wait<0>();
  __syncthreads();

  const int n0 = warp * 16;
  if (n0 >= N) return;
  float acc[kMaxP / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int depth = (len + 15) & ~15, j2 = 2 * (lane & 3);
  for (int k0 = 0; k0 < depth; k0 += 16) {
    uint32_t af[4], ah[4], al[4];  // B^T rows n0.., columns (positions) k0..
    ldmatrix_x4_trans(af, b_s + (k0 + (lane & 7) + (lane >> 4) * 8) * dim.ldn + n0 +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // registers 0, 1: positions k0 + j2; 2, 3: + 8
      const int j = k0 + j2 + (q >> 1) * 8;
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&af[q]));
      split_bf16(f.x * w_s[j], f.y * w_s[j + 1], ah[q], al[q]);
    }
    mma_hi_lo<kMaxP / 8>(acc, ah, al, x_s + k0 * dim.ldp, dim.ldp, P);
  }
  float* out = states + (((size_t)b * nc + c) * H + h) * N * P;
  const int r = n0 + (lane >> 2);
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n) {
    const int p = n * 8 + j2;
    if (p < P) {
      if (r < N) *reinterpret_cast<float2*>(out + (size_t)r * P + p) = make_float2(acc[n][0], acc[n][1]);
      if (r + 8 < N)
        *reinterpret_cast<float2*>(out + (size_t)(r + 8) * P + p) = make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// grid (ceil(N*P / (4 * kThreads)), H, B): each thread walks one float4 of
// the state through the chunks, leaving the state before each chunk.
__global__ void __launch_bounds__(kThreads)
ssd_scan_carry(float* __restrict__ states, const float* __restrict__ decay,
               float* __restrict__ state_out, int H, int np4, int nc) {
  const int e = blockIdx.x * kThreads + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  if (e >= np4) return;
  constexpr int kAhead = 8;  // chunks whose loads are in flight together
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 own[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c0 + u < nc) {
        const size_t bch = ((size_t)b * nc + c0 + u) * H + h;
        own[u] = reinterpret_cast<const float4*>(states)[bch * np4 + e];
        dec[u] = decay[bch];
      }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c0 + u < nc) {
        const size_t bch = ((size_t)b * nc + c0 + u) * H + h;
        reinterpret_cast<float4*>(states)[bch * np4 + e] = s;
        s.x = dec[u] * s.x + own[u].x;
        s.y = dec[u] * s.y + own[u].y;
        s.z = dec[u] * s.z + own[u].z;
        s.w = dec[u] * s.w + own[u].w;
      }
  }
  reinterpret_cast<float4*>(state_out)[((size_t)b * H + h) * np4 + e] = s;
}

// grid (H, chunks, B), kOutThreads.  Each of the 16 warps owns one 16-row
// tile of the chunk's y (rows i); tiles are dealt so that the four warps of
// each scheduler share out the causal work evenly (tile t has t + 1 key
// blocks; each scheduler gets tiles summing to 34 blocks at Q = 256).
template <typename TY>
__global__ void __launch_bounds__(kOutThreads, 1)
ssd_scan_out(const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
             const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
             const float* __restrict__ states, TY* __restrict__ y, int S, int H, int P, int N,
             int chunk) {
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int c0 = c * chunk, len = min(chunk, S - c0);
  const ChunkDims dim(chunk, N, P);
  const int n16 = (N + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ __align__(128) unsigned char smem[];
  double* cum_s = reinterpret_cast<double*>(smem);
  double* warp_s = cum_s + kMaxChunk;
  float* dt_s = reinterpret_cast<float*>(warp_s + 32);
  bf16* c_s = reinterpret_cast<bf16*>(dt_s + dim.rows);
  bf16* b_s = c_s + dim.rows * dim.ldn;
  bf16* x_s = b_s + dim.rows * dim.ldn;
  bf16* shi_s = x_s + dim.rows * dim.ldp;
  bf16* slo_s = shi_s + n16 * dim.ldp;

  const size_t at = ((size_t)b * S + c0) * H + h;
  stage_rows(c_s, dim.ldn, Cm + ((size_t)b * S + c0) * N, N, dim.rows, len, N);
  cp_async_commit();
  stage_rows(b_s, dim.ldn, Bm + ((size_t)b * S + c0) * N, N, dim.rows, len, N);
  stage_rows(x_s, dim.ldp, x + at * P, (size_t)H * P, dim.rows, len, P);
  cp_async_commit();
  // S_prev (N x P f32) as bf16 hi + lo; rows N .. n16 zero.  All of a
  // thread's loads are issued before the first is used.
  const float* sp = states + (((size_t)b * nc + c) * H + h) * N * P;
  {
    constexpr int kPer = kMaxN * kMaxP / 4 / kOutThreads;  // float4s a thread
    const int q4 = P / 4;
    float4 v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kOutThreads, n = e / q4;
      v[i] = e < n16 * q4 && n < N ? *reinterpret_cast<const float4*>(sp + (size_t)e * 4)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kOutThreads, n = e / q4, p = (e - n * q4) * 4;
      if (e < n16 * q4) {
        uint2 hv, lv;
        split_bf16(v[i].x, v[i].y, hv.x, lv.x);
        split_bf16(v[i].z, v[i].w, hv.y, lv.y);
        *reinterpret_cast<uint2*>(shi_s + n * dim.ldp + p) = hv;
        *reinterpret_cast<uint2*>(slo_s + n * dim.ldp + p) = lv;
      }
    }
  }
  chunk_cumsum(a, at, H, len, cum_s, warp_s);
  if (tid < dim.rows) dt_s[tid] = tid < len ? dt[at + (size_t)tid * H] : 0.f;
  cp_async_wait<1>();  // C has landed
  __syncthreads();

  const int sub = warp & 3, quarter = warp >> 2;  // scheduler, and this warp's turn on it
  const int tile = quarter == 0 ? sub : quarter == 1 ? 15 - sub : quarter == 2 ? 7 - sub : 8 + sub;
  const bool busy = tile < (len + 15) >> 4;
  const int i0 = tile * 16, g = lane >> 2, c2 = 2 * (lane & 3);
  float acc[kMaxP / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t cf[kMaxN / 16][4];  // C rows i0.. as A tiles over N
  if (busy) {
#pragma unroll
    for (int k = 0; k < kMaxN / 16; ++k)
      if (k * 16 < n16) ldmatrix_x4(cf[k], c_s + (i0 + (lane & 15)) * dim.ldn + k * 16 + (lane >> 4) * 8);
    // y = exp(cum_i) * (C S_prev)
    // S_prev hi and lo as two B operands, the same C times each
#pragma unroll
    for (int k = 0; k < kMaxN / 16; ++k)
      if (k * 16 < n16) {
        mma_rows<kMaxP / 8>(acc, cf[k], shi_s + k * 16 * dim.ldp, dim.ldp, P);
        mma_rows<kMaxP / 8>(acc, cf[k], slo_s + k * 16 * dim.ldp, dim.ldp, P);
      }
    const float e0 = expf((float)cum_s[min(i0 + g, len - 1)]);
    const float e1 = expf((float)cum_s[min(i0 + g + 8, len - 1)]);
#pragma unroll
    for (int n = 0; n < kMaxP / 8; ++n) {
      acc[n][0] *= e0;
      acc[n][1] *= e0;
      acc[n][2] *= e1;
      acc[n][3] *= e1;
    }
  }
  cp_async_wait<0>();  // B and x have landed
  __syncthreads();
  if (!busy) return;

  // y += ((C B^T) o L o dt) x, 16 keys at a time up to the diagonal
  const int ia = i0 + g, ib = ia + 8;
  const double cum_a = cum_s[min(ia, len - 1)], cum_b = cum_s[min(ib, len - 1)];
  for (int j0 = 0; j0 <= i0; j0 += 16) {
    // C B^T for 16 rows x 16 keys, the sum over N in two independent halves
    float s[2][2][4] = {};
#pragma unroll
    for (int k = 0; k < kMaxN / 16; ++k)
      if (k * 16 < n16) {
        uint32_t bk[4];
        ldmatrix_x4(bk, b_s + (j0 + (lane & 7) + (lane >> 4) * 8) * dim.ldn + k * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[k & 1][0], cf[k], bk[0], bk[1]);
        mma_bf16(s[k & 1][1], cf[k], bk[2], bk[3]);
      }
    // G_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i < len, else 0
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ia : ib, j = j0 + n * 8 + c2 + (e & 1);
        const float cb = s[0][n][e] + s[1][n][e];
        s[0][n][e] = j <= i && i < len
                         ? cb * expf((float)((e < 2 ? cum_a : cum_b) - cum_s[j])) * dt_s[j]
                         : 0.f;
      }
    uint32_t gh[4], gl[4];
    split_bf16(s[0][0][0], s[0][0][1], gh[0], gl[0]);
    split_bf16(s[0][0][2], s[0][0][3], gh[1], gl[1]);
    split_bf16(s[0][1][0], s[0][1][1], gh[2], gl[2]);
    split_bf16(s[0][1][2], s[0][1][3], gh[3], gl[3]);
    mma_hi_lo<kMaxP / 8>(acc, gh, gl, x_s + j0 * dim.ldp, dim.ldp, P);
  }
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n) {
    const int p = n * 8 + c2;
    if (p >= P) continue;
    if (ia < len) store2(y + (at + (size_t)ia * H) * P + p, acc[n][0], acc[n][1]);
    if (ib < len) store2(y + (at + (size_t)ib * H) * P + p, acc[n][2], acc[n][3]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename TY>
int launch_chunked(const bf16* x, const float* dt, const float* a, const bf16* Bm, const bf16* Cm,
                   TY* y, float* state, float* states, float* decay, int B, int S, int H, int P,
                   int N, int chunk, cudaStream_t stream) {
  if (B == 0 || H == 0 || S == 0) return (int)cudaGetLastError();
  const int nc = (S + chunk - 1) / chunk, np4 = N * P / 4;
  const ChunkDims dim(chunk, N, P);
  cudaError_t err;
  if ((err = allow_smem(ssd_scan_states, dim.states_bytes())) != cudaSuccess) return (int)err;
  if ((err = allow_smem(ssd_scan_out<TY>, dim.out_bytes(N))) != cudaSuccess) return (int)err;
  ssd_scan_states<<<dim3(H, nc, B), kThreads, dim.states_bytes(), stream>>>(
      x, dt, a, Bm, S, H, P, N, chunk, states, decay);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++g_kernels;
  ssd_scan_carry<<<dim3((np4 + kThreads - 1) / kThreads, H, B), kThreads, 0, stream>>>(
      states, decay, state, H, np4, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++g_kernels;
  ssd_scan_out<TY><<<dim3(H, nc, B), kOutThreads, dim.out_bytes(N), stream>>>(
      x, dt, a, Bm, Cm, states, y, S, H, P, N, chunk);
  if ((err = cudaGetLastError()) == cudaSuccess) ++g_kernels;
  return (int)err;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  x, B_ and C_ share x's dtype;
// y is written in y's; dt, a and the state are f32.  Shapes: x, y
// (B, S, H, P); dt, a (B, S, H); B_, C_ (B, S, N); state (B, H, N, P); all
// contiguous and 16-byte aligned.  N and P multiples of 8, N <= 128,
// P <= 64, 1 <= chunk <= 256.  bf16 x takes the chunk-parallel variant,
// whose scratch is `states` (B, chunks, H, N, P) and `decay` (B, chunks,
// H), f32, chunks = ceil(S / chunk); f32 x the FMA variant, which does not
// read them (they may be null).
int ssd_scan(int x_dtype, int y_dtype, const void* x, const float* dt, const float* a,
             const void* Bm, const void* Cm, void* y, float* state, float* states, float* decay,
             int B, int S, int H, int P, int N, int chunk, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N < 8 || N % 8 != 0 || N > kMaxN || P < 8 || P % 8 != 0 || P > kMaxP || chunk < 1 ||
      chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  const bf16 *xb = static_cast<const bf16*>(x), *Bb = static_cast<const bf16*>(Bm),
             *Cb = static_cast<const bf16*>(Cm);
  if (x_dtype == 1 && y_dtype == 0)
    return launch_chunked<float>(xb, dt, a, Bb, Cb, static_cast<float*>(y), state, states, decay,
                                 B, S, H, P, N, chunk, st);
  if (x_dtype == 1 && y_dtype == 1)
    return launch_chunked<bf16>(xb, dt, a, Bb, Cb, static_cast<bf16*>(y), state, states, decay, B,
                                S, H, P, N, chunk, st);
  if (x_dtype == 0 && y_dtype == 0)
    return launch<float, float>(x, dt, a, Bm, Cm, y, state, B, S, H, P, N, chunk, st);
  if (x_dtype == 0 && y_dtype == 1)
    return launch<float, bf16>(x, dt, a, Bm, Cm, y, state, B, S, H, P, N, chunk, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

long long ssd_scan_kernels_launched() { return g_kernels.load(); }

}  // extern "C"
