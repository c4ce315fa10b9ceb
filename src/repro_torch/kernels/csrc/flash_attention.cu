// Flash attention (forward) for Hopper (sm_90a): causal and/or
// sliding-window grouped-query attention over a whole sequence, online
// softmax over KV tiles.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (launched by flash_attention, :89).  It computes the same function:
//
//   out[b,s,h] = softmax_k(q[b,s,h] . K[b,k,h/rep] / sqrt(D), masked) . V[b,k,h/rep]
//
// with rep = H / KVH; the mask keeps kpos < Skv, kpos <= qpos when causal,
// kpos > qpos - window when window > 0 (positions compared as absolute
// indices, as the Pallas kernel and the oracle do).  Scores, softmax
// statistics and the accumulator are f32; out = acc / max(l, 1e-30) in q's
// dtype.  The plain PyTorch version is
// src/repro_torch/kernels/ref.py:mha_reference.
//
// Masked entries are written as exactly 0 where the Pallas body gives them
// exp(-1e30 - m): in a row's first visible tile whose keys are all masked
// that is exp(0) = 1, which only a later rescale by exp(-1e30 - m) = 0
// wipes.  Both give the same result for every row that has a valid key; a
// row with none gives 0 here.
//
// What bounds it on an H100.  Per (query, key) pair inside the causal band
// or the window it does 4*D flops against a few bytes (each K/V tile is
// reused by 64 query rows from shared memory), so it is bound by
// operations: useful FLOPs / peak.  The bf16 peak (989 TFLOP/s) needs the
// tensor cores; this first kernel computes both products with f32 FMAs on
// the CUDA cores (67 TFLOP/s peak), for f32 and bf16 inputs alike, so it
// stays an order of magnitude above the bf16 bound.  wgmma and TMA come
// later.
//
// What the design does.
// (1) The Pallas grid (B, H, Sq/bq, Skv/bk) walks KV blocks as its
//     sequential last axis with (m, l, acc) in VMEM.  Here one CTA owns a
//     (row b, kv head g, query tile) and loops over the KV tiles itself,
//     keeping (m, l) and the accumulator in registers.
// (2) GQA: the CTA's 64 query rows are (position, q head) pairs of ONE kv
//     head's group (64 / rep positions x rep heads), so each K/V tile is
//     read once for the whole group, where the Pallas grid reads it once
//     per q head.
// (3) Tiles wholly outside the causal band or the window are never
//     loaded (the Pallas kernel's pl.when skip); the ragged KV tail and the
//     band edges are masked per element, so nothing is padded.
// (4) Register tiles: thread (tr, tc) of 16 x 16 computes a 4 x 4 block of
//     scores (rows tr*4.., keys tc + 16j) from float4 reads of shared Q
//     and K rows padded to D + 4 floats (conflict-free for D a multiple of
//     8), then a 4 x ceil(D/16) block of the output (dims tc + 16j) from
//     the probabilities staged in shared memory.  The same thread holds
//     the same rows in both products, so the row statistics never leave
//     registers.  Any D that is a multiple of 8 up to 128 is taken as it
//     is (h2o_danube's 120 included): the last dims are masked.
//
// The entry point returns cudaGetLastError() (or the first error of a
// runtime call) as an int; the Python wrapper raises when it is non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;            // query rows (position, head) a CTA
constexpr int kTile = 64;            // keys per shared-memory tile
constexpr int kMaxD = 128;
constexpr int kMaxJ = kMaxD / 16;    // output dims a thread
constexpr int kLdp = kTile + 4;      // padded row of the probabilities
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of T from global memory into floats (4 for f32, 8 for bf16).
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

// rows x D elements of T (row r at src + row_off(r)) into a shared f32
// tile with row stride ld; rows where valid(r) is false are zero-filled.
template <typename T, typename Off, typename Valid>
__device__ __forceinline__ void stage(float* dst, int rows, int D, int ld, Off row_off,
                                      Valid valid, const T* src) {
  constexpr int vec = 16 / sizeof(T);
  const int per_row = D / vec;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * vec;
    float tmp[vec];
    if (valid(r)) {
      load16(src + row_off(r) + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < vec; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < vec; ++e) dst[r * ld + c + e] = tmp[e];
  }
}

size_t smem_bytes(int D) {
  return ((size_t)(kRows + 2 * kTile) * (D + 4) + (size_t)kRows * kLdp) * sizeof(float);
}

// grid (ceil(Sq / (kRows / rep)), KVH, B), kThreads threads.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_fwd(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, TQ* __restrict__ out, int Sq, int Skv, int H,
                    int KVH, int D, int causal, int window, float scale) {
  const int g = blockIdx.y, b = blockIdx.z;
  const int rep = H / KVH;
  const int bq = kRows / rep;             // query positions of the tile
  const int rows = bq * rep;              // rows in use (kRows when rep | 64)
  const int q0 = blockIdx.x * bq;
  const int ld = D + 4;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // (kRows, ld)
  float* k_s = q_s + kRows * ld;                // (kTile, ld)
  float* v_s = k_s + kTile * ld;                // (kTile, ld)
  float* p_s = v_s + kTile * ld;                // (kRows, kLdp)

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int jd = (D + 15) / 16;

  // row r = position r / rep, q head g * rep + r % rep: for one position
  // the group's rep heads are rep * D contiguous elements
  stage<TQ>(q_s, kRows, D, ld,
            [&](int r) { return (((size_t)b * Sq + q0 + r / rep) * H + g * rep) * D + (size_t)(r % rep) * D; },
            [&](int r) { return r < rows && q0 + r / rep < Sq; }, q);

  float m_i[4], l_i[4], acc[4][kMaxJ];
  int qpos[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    qpos[i] = q0 + r / rep;
    live[i] = r < rows && qpos[i] < Sq;
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) acc[i][j] = 0.f;
  }

  // the KV tiles that touch the tile's band
  const int q_last = min(q0 + bq, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_end = (k_end + kTile - 1) / kTile;

  for (int t = k_begin / kTile; t < t_end; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's K, V and P reads are done
    const size_t kv_base = (size_t)b * Skv * KVH * D + (size_t)g * D;
    stage<TKV>(k_s, kTile, D, ld, [&](int j) { return kv_base + (size_t)(k0 + j) * KVH * D; },
               [&](int j) { return k0 + j < Skv; }, k);
    stage<TKV>(v_s, kTile, D, ld, [&](int j) { return kv_base + (size_t)(k0 + j) * KVH * D; },
               [&](int j) { return k0 + j < Skv; }, v);
    __syncthreads();

    // scores s[i][j] = q_row(tr*4+i) . k_row(tc+16j)
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < D; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(q_s + (tr * 4 + i) * ld + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(k_s + (tc + 16 * j) * ld + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y + qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

    // online softmax; the 16 threads of a row are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 16 * j;
        ok[j] = live[i] && kpos < Skv && (!causal || kpos <= qpos[i]) &&
                (!window || kpos > qpos[i] - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[(tr * 4 + i) * kLdp + tc + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_i[i] = l_i[i] * corr + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc[i][j] += sum_k p[row, k] * v[k, tc + 16j]
    const int nk = min(kTile, Skv - k0);
    for (int kk = 0; kk < nk; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(p_s + (tr * 4 + i) * kLdp + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = v_s + (kk + e) * ld;
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          if (j < jd) {
            const int d = tc + 16 * j;
            const float vv = d < D ? vr[d] : 0.f;
            const float p0 = e == 0 ? pv[0].x : e == 1 ? pv[0].y : e == 2 ? pv[0].z : pv[0].w;
            const float p1 = e == 0 ? pv[1].x : e == 1 ? pv[1].y : e == 2 ? pv[1].z : pv[1].w;
            const float p2 = e == 0 ? pv[2].x : e == 1 ? pv[2].y : e == 2 ? pv[2].z : pv[2].w;
            const float p3 = e == 0 ? pv[3].x : e == 1 ? pv[3].y : e == 2 ? pv[3].z : pv[3].w;
            acc[0][j] += p0 * vv;
            acc[1][j] += p1 * vv;
            acc[2][j] += p2 * vv;
            acc[3][j] += p3 * vv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    const int r = tr * 4 + i;
    TQ* o = out + (((size_t)b * Sq + qpos[i]) * H + g * rep + r % rep) * D;
    const float l = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int d = tc + 16 * j;
      if (j < jd && d < D) o[d] = from_f32<TQ>(acc[i][j] / l);
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv, int H,
           int KVH, int D, int causal, int window, float scale, cudaStream_t stream) {
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd<TQ, TKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bq = kRows / (H / KVH);
  const dim3 grid((Sq + bq - 1) / bq, KVH, B);
  flash_attention_fwd<TQ, TKV><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(out), Sq, Skv, H, KVH, D, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  q and out share q's dtype, k
// and v theirs.  Shapes: q, out (B, Sq, H, D); k, v (B, Skv, KVH, D); all
// contiguous and 16-byte aligned.  H is a multiple of KVH with
// H / KVH <= 64; D a multiple of 8, at most 128; window 0 = none.
int flash_attention(int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
                    void* out, int B, int Sq, int Skv, int H, int KVH, int D, int causal,
                    int window, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (KVH < 1 || H % KVH != 0 || H / KVH > kRows || D < 8 || D % 8 != 0 || D > kMaxD ||
      window < 0)
    return (int)cudaErrorInvalidValue;
#define FA_CASE(TQ, TKV) \
  return launch<TQ, TKV>(q, k, v, out, B, Sq, Skv, H, KVH, D, causal, window, scale, st)
  if (q_dtype == 0 && kv_dtype == 0) FA_CASE(float, float);
  if (q_dtype == 0 && kv_dtype == 1) FA_CASE(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 0) FA_CASE(__nv_bfloat16, float);
  if (q_dtype == 1 && kv_dtype == 1) FA_CASE(__nv_bfloat16, __nv_bfloat16);
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
