// Split-KV flash decode for Hopper (sm_90a): one query token per row
// attends a KV cache, grouped-query attention, online softmax.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:_kernel
// (launched by flash_decode, :70).  It computes the same outputs:
//
//   out[b,h] = softmax(q[b,h] . K[b,:,h/rep]^T / sqrt(D), masked to
//              kpos < kv_len[b]) . V[b,:,h/rep]      (f32 sums, q's dtype)
//   m[b,h]   = max of the valid scaled logits         (f32)
//   l[b,h]   = sum over valid keys of exp(s - m)      (f32)
//   out      = acc / max(l, 1e-30)
//
// A row with kv_len = 0 gives out = 0, m = -1e30, l = 0, as the Pallas
// kernel does when it skips every block.  The plain PyTorch version is
// src/repro_torch/kernels/ref.py:decode_reference.
//
// What bounds it on an H100.  Per key it reads D keys and D values and
// does ~4*rep*D flops (rep = H / KVH query heads share one kv head): at
// rep = 4 that is one flop per byte of bf16, two orders of magnitude under
// the card's balance point.  The kernel is bound by the bytes of the valid
// cache prefix (sum_b kv_len_b * KVH * D * 2 * itemsize) and, at decode
// sizes (a few MB), by the latency of getting enough loads in flight.
//
// What the design does about it.
// (1) Each K/V tile is read from device memory once for the whole GQA
//     group: one CTA per (row, kv head, split) holds the rep query heads,
//     where the Pallas grid (B, H, S/block_k) reads every block once per q
//     head.
// (2) The KV axis is split across CTAs so that B*KVH*splits fills the 132
//     SMs several times over (B*KVH is only 64 for granite at pool 8).
//     Tiles go to splits round-robin (tile t to split t mod splits), so
//     every split gets an even share of the VALID tiles whatever kv_len
//     is; tiles wholly past kv_len[b] are never touched.  A second small
//     kernel merges the splits' (m, l, acc) partials with the associative
//     combine M = max m_s, L = sum l_s e^(m_s - M), acc = sum acc_s e^(m_s-M).
// (3) Tiles of 64 keys are staged in shared memory with 16-byte loads,
//     rows padded by 16 bytes so the per-key dot products of a quarter
//     warp hit distinct banks; the ragged last tile is zero-filled and its
//     scores masked.  Scores, softmax statistics and the accumulator stay
//     in f32 (accumulator in registers).
// wgmma, TMA and a deeper load pipeline are later work.
//
// The entry point returns cudaGetLastError() (or the first error of a
// runtime call) as an int; the Python wrapper raises when it is non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;        // keys per shared-memory tile
constexpr int kMaxAcc = 16;      // accumulator elements per thread
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Dot product of one 16-byte chunk of a K row with q (f32, shared).
__device__ __forceinline__ float dot16(const float* kc, const float* q) {
  const float4 k4 = *reinterpret_cast<const float4*>(kc);
  return k4.x * q[0] + k4.y * q[1] + k4.z * q[2] + k4.w * q[3];
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* kc, const float* q) {
  const uint4 raw = *reinterpret_cast<const uint4*>(kc);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    s += f.x * q[2 * i] + f.y * q[2 * i + 1];
  }
  return s;
}

size_t smem_bytes(int rep, int D, int kv_size) {
  const size_t head = ((size_t)rep * D + (size_t)rep * kTile + 3 * (size_t)rep) * sizeof(float);
  const size_t ld = D + 16 / kv_size;
  return ((head + 15) & ~(size_t)15) + 2 * (size_t)kTile * ld * kv_size;
}

// Pass 1: grid (splits, KVH, B).  Writes the split's unnormalised
// partials m_part, l_part (B, H, splits) and acc_part (B, H, splits, D).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
flash_decode_partial(const TQ* __restrict__ q, const TKV* __restrict__ k,
                     const TKV* __restrict__ v, const int* __restrict__ kv_len, int S, int H,
                     int KVH, int D, float scale, float* __restrict__ m_part,
                     float* __restrict__ l_part, float* __restrict__ acc_part) {
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int rep = H / KVH;
  const int len = min(max(kv_len[b], 0), S);
  constexpr int vec = 16 / sizeof(TKV);          // elements per 16-byte load
  const int ld = D + vec;                        // padded shared row

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);   // (rep, D)
  float* p_s = q_s + rep * D;                    // (rep, kTile) scores, then p
  float* m_s = p_s + rep * kTile;                // (rep,) running max
  float* l_s = m_s + rep;                        // (rep,) running sum
  float* c_s = l_s + rep;                        // (rep,) this tile's rescale
  const size_t head = ((size_t)rep * D + (size_t)rep * kTile + 3 * (size_t)rep) * sizeof(float);
  TKV* k_s = reinterpret_cast<TKV*>(smem + ((head + 15) & ~(size_t)15));
  TKV* v_s = k_s + kTile * ld;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hq0 = g * rep;                       // first q head of the group
  const TQ* qb = q + ((size_t)b * H + hq0) * D;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = to_f32(qb[i]);
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int n_acc = (rep * D + kThreads - 1) / kThreads;
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  const size_t row = (size_t)KVH * D;            // elements from key to key
  const TKV* kb = k + (size_t)b * S * row + (size_t)g * D;
  const TKV* vb = v + (size_t)b * S * row + (size_t)g * D;
  const int vecs = D / vec;
  const int n_tiles = (len + kTile - 1) / kTile;
  __syncthreads();

  for (int t = split; t < n_tiles; t += n_split) {
    const int k0 = t * kTile;
    const int nk = min(kTile, len - k0);
    for (int i = tid; i < kTile * vecs; i += kThreads) {
      const int j = i / vecs, c = (i - j * vecs) * vec;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (j < nk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + j) * row + c);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + j) * row + c);
      }
      *reinterpret_cast<uint4*>(k_s + j * ld + c) = kv;
      *reinterpret_cast<uint4*>(v_s + j * ld + c) = vv;
    }
    __syncthreads();

    // scores: thread -> key j, heads r = tid / kTile + n * (kThreads / kTile)
    {
      const int j = tid % kTile;
      for (int r = tid / kTile; r < rep; r += kThreads / kTile) {
        float s = kNegInf;
        if (j < nk) {
          float dot = 0.f;
          for (int c = 0; c < D; c += vec) dot += dot16(k_s + j * ld + c, q_s + r * D + c);
          s = dot * scale;
        }
        p_s[r * kTile + j] = s;
      }
    }
    __syncthreads();

    // online softmax: one warp per head, two keys per lane
    for (int r = warp; r < rep; r += kThreads / 32) {
      const float s0 = p_s[r * kTile + lane], s1 = p_s[r * kTile + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = lane < nk ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < nk ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[r * kTile + lane] = p0;
      p_s[r * kTile + lane + 32] = p1;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc[r, d] = acc * corr[r] + sum_j p[r, j] * v[j, d]
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + i * kThreads;
      if (i < n_acc && e < rep * D) {
        const int r = e / D, d = e - r * D;
        const float* pr = p_s + r * kTile;
        float a = 0.f;
        for (int j = 0; j < nk; ++j) a += pr[j] * to_f32(v_s[j * ld + d]);
        acc[i] = acc[i] * c_s[r] + a;
      }
    }
    __syncthreads();
  }

  const size_t bh0 = (size_t)b * H + hq0;
  for (int r = tid; r < rep; r += kThreads) {
    m_part[(bh0 + r) * n_split + split] = m_s[r];
    l_part[(bh0 + r) * n_split + split] = l_s[r];
  }
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (i < n_acc && e < rep * D) {
      const int r = e / D, d = e - r * D;
      acc_part[((bh0 + r) * n_split + split) * D + d] = acc[i];
    }
  }
}

// Pass 2: grid (B * H).  Merges the splits of one (row, q head).
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine(const float* __restrict__ m_part, const float* __restrict__ l_part,
                     const float* __restrict__ acc_part, int n_split, int D,
                     TQ* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out) {
  const size_t bh = blockIdx.x;
  const float* mp = m_part + bh * n_split;
  const float* lp = l_part + bh * n_split;
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, mp[s]);
  float L = 0.f;
  for (int s = 0; s < n_split; ++s) L += lp[s] * expf(mp[s] - M);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s) a += acc_part[(bh * n_split + s) * D + d] * expf(mp[s] - M);
    out[bh * D + d] = from_f32<TQ>(a * inv);
  }
  if (threadIdx.x == 0) {
    m_out[bh] = M;
    l_out[bh] = L;
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* kv_len, int B, int S, int H,
           int KVH, int D, int n_split, float scale, float* m_part, float* l_part,
           float* acc_part, void* out, float* m_out, float* l_out, cudaStream_t stream) {
  cudaError_t err;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  const int rep = H / KVH;
  const size_t smem = smem_bytes(rep, D, (int)sizeof(TKV));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(flash_decode_partial<TQ, TKV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_decode_partial<TQ, TKV><<<dim3(n_split, KVH, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), kv_len,
      S, H, KVH, D, scale, m_part, l_part, acc_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_decode_combine<TQ><<<B * H, kThreads, 0, stream>>>(m_part, l_part, acc_part, n_split, D,
                                                           static_cast<TQ*>(out), m_out, l_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  q and out share q's dtype,
// k and v the cache's.  Shapes: q, out (B, H, D); k, v (B, S, KVH, D);
// kv_len (B,) int32; m_out, l_out (B, H); scratch m_part, l_part
// (B, H, n_split) and acc_part (B, H, n_split, D), all f32.  Every tensor
// is contiguous; D is a multiple of 8, at most 256, with rep * D <= 2048.
int flash_decode(int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
                 const int* kv_len, int B, int S, int H, int KVH, int D, int n_split,
                 float scale, float* m_part, float* l_part, float* acc_part, void* out,
                 float* m_out, float* l_out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (KVH < 1 || H % KVH != 0 || D % 8 != 0 || D > 256 || (H / KVH) * D > kThreads * kMaxAcc ||
      n_split < 1)
    return (int)cudaErrorInvalidValue;
#define FD_CASE(TQ, TKV)                                                                      \
  return launch<TQ, TKV>(q, k, v, kv_len, B, S, H, KVH, D, n_split, scale, m_part, l_part, \
                         acc_part, out, m_out, l_out, st)
  if (q_dtype == 0 && kv_dtype == 0) FD_CASE(float, float);
  if (q_dtype == 0 && kv_dtype == 1) FD_CASE(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 0) FD_CASE(__nv_bfloat16, float);
  if (q_dtype == 1 && kv_dtype == 1) FD_CASE(__nv_bfloat16, __nv_bfloat16);
#undef FD_CASE
  return (int)cudaErrorInvalidValue;
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
