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
// indices, as the Pallas kernel and the oracle do).  A query row s stands
// at position qpos = q_offset + s: q_offset > 0 is a block of query rows
// of a longer sequence against its whole K/V (the sequence-parallel
// attention of a mesh, src/repro/models/attention.py:162-172), and every
// use of a position below (the causal and window tile ranges, the
// per-row bounds, the edge-tile tests, the longest-first order) takes
// it; row indices stay row indices (the loads of Q, the output rows).  Scores, softmax
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
// Two variants, chosen by the wrapper by dtype alone:
//   flash_attention_wgmma  bf16 q with bf16 k/v: both products on the
//                          tensor cores (wgmma), tiles brought by TMA;
//   flash_attention_fwd    every other pair (f32, and f32/bf16 mixed):
//                          f32 FMAs on the CUDA cores, so the float32
//                          checks (2e-5; 1e-3 end to end with TF32 off)
//                          see no TF32 or bf16 rounding.
//
// What bounds it on an H100.  Per (query, key) pair inside the causal band
// or the window it does 4*D flops against a few bytes (each K/V tile is
// reused by a whole CTA's query rows from shared memory), so it is bound
// by operations: useful FLOPs / peak (989 TFLOP/s bf16 on the tensor
// cores, 67 TFLOP/s f32 on the CUDA cores).
//
// flash_attention_wgmma (sm_90a only).
// (1) A CTA owns 128 query rows of one (row b, kv head g): the rows are
//     (position, q head) pairs, 128 / rep positions x the group's rep
//     heads, so each K/V tile is read once for the whole group.  WG0 and
//     WG1 each own 64 rows and run wgmma; one thread of a ninth warp
//     issues every TMA copy.  Nine warps put three on one SM
//     sub-partition, whose 16K registers cap a thread at 168: room for
//     S (64 f32), O (32 or 64) and P (32 + 32).  The registers and spill
//     bytes of each instantiation are what tools/probe_prefill_kernels.py
//     prints from -Xptxas -v.
// (2) TMA: 4-D tensor maps (D, heads, S, B) over the untouched layouts
//     with 128-byte swizzle, one map per tensor encoded on the host each
//     call.  A tile is 64-column panels of 128 rows x 128 B (one panel for
//     D <= 64, two for D <= 128).  The map's own extents zero-fill what
//     lies outside: columns D..63/127 (D = 16, 32, 120), positions past
//     Sq or Skv (a ragged last tile never reads the next row b).  K and V
//     go through a ring of stages (4 for one panel, 2 for two), each with
//     a full barrier for K, one for V (so QK^T starts before V lands) and
//     an empty barrier the 8 consumer warps arrive on.
// (3) S = Q K^T: wgmma m64n128k16, A = Q and B = K from shared memory,
//     both K-major, 16 columns a step (32 bytes into the swizzled row).
//     O += P V: wgmma m64n{64,128}k16, A = P from registers (the f32
//     accumulator fragment of S maps onto the bf16 A fragment without a
//     shuffle), B = V from shared memory MN-major (the transpose bit):
//     LBO = the panel stride, SBO = 8 keys x 128 B.
// (4) Online softmax in registers on the accumulator layout: each thread
//     holds 2 rows, the row max and sum take 2 quad shuffles, scale and
//     log2 e are folded into one multiply, and ex2.approx.ftz takes the
//     exponent (exp2f adds a rescale for denormal results).  The causal, window
//     and Skv mask is applied only on tiles that straddle an edge of the
//     warpgroup's band; tiles wholly outside the CTA's band are never
//     loaded.  Masked scores are -inf, so their probabilities are exactly
//     0, and a row with no valid key ends at 0 (acc / max(l, 1e-30)).
// (5) P is split into bf16 hi + lo parts (p = hi + lo to ~16 bits) and
//     both are multiplied by V: P rounded once to bf16 moves an output by
//     up to 2^-9 of the |v| it averages, and at the prefill path's
//     activations (|v| up to ~120) that misses the 2e-2 kernel-vs-plain
//     check where values cancel (tools/prefill_accuracy.py measures the
//     plain version with P rounded once).  The split costs a second P V
//     product.
// (6) Longest causal CTAs launch first (the q tile index is reversed and
//     slowest), so the short ones fill the tail of the last wave; a
//     later tile's band is never the shorter one at any q_offset.
// What bounds it: at D = 128 (danube) the tensor cores, with the split
// doubling the P V products; at D = 64 (granite) the softmax's
// instruction issue and exponentials, for which a tile's products are
// too short to hide them.
// (7) Epilogue: each warpgroup writes its bf16 output into its own Q rows
//     of shared memory (same swizzle, so conflict-free), then stores rows
//     with 16-byte writes, masked to valid positions and D columns.
//
// flash_attention_fwd (the first kernel, kept for f32 and mixed dtypes).
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
// The entry points return cudaGetLastError() (or the first error of a
// runtime call, or kEncodeError + the CUresult when a tensor map
// cannot be encoded) as an int; the Python wrapper raises when it is
// non-zero.

#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda (see wg::encoder)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
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
                    int KVH, int D, int causal, int window, int q_offset, float scale) {
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
  int qrow[4], qpos[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    qrow[i] = q0 + r / rep;
    qpos[i] = q_offset + qrow[i];
    live[i] = r < rows && qrow[i] < Sq;
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) acc[i][j] = 0.f;
  }

  // the KV tiles that touch the tile's band (positions)
  const int q_last = q_offset + min(q0 + bq, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = window ? max(0, q_offset + q0 - window + 1) : 0;
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
    TQ* o = out + (((size_t)b * Sq + qrow[i]) * H + g * rep + r % rep) * D;
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
           int KVH, int D, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd<TQ, TKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bq = kRows / (H / KVH);
  const dim3 grid((Sq + bq - 1) / bq, KVH, B);
  flash_attention_fwd<TQ, TKV><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(out), Sq, Skv, H, KVH, D, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// flash_attention_wgmma: bf16 q, k, v on the tensor cores (sm_90a).

namespace wg {

constexpr int kRows = 128;               // query rows a CTA (2 x 64)
constexpr int kKeys = 128;               // keys a K/V tile
constexpr int kPanelBytes = 128 * 128;   // 128 rows x 64 bf16 columns
constexpr int kThreads = 288;            // WG0, WG1 consume; warp 8 produces
constexpr int kEncodeError = 20000;      // + CUresult of a failed encode

// Shared memory from a 1024-byte aligned base (the swizzle atom): Q
// panels, K stages, V stages, then the barriers.
template <int NP, int STAGES>
struct Layout {
  static constexpr int q = 0;
  static constexpr int k = NP * kPanelBytes;
  static constexpr int v = k + STAGES * NP * kPanelBytes;
  static constexpr int bars = v + STAGES * NP * kPanelBytes;
  static constexpr int bytes = bars + 8 * (1 + 3 * STAGES) + 1024;  // + alignment slack
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// Returns once the barrier's phase of the given parity has completed; a
// wait that spins past any tile's time (seconds) traps, so a fault in the
// pipeline ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    if (++spins == (1u << 28)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of a 4-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving accesses of r across an async wgmma.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_D32(d, o)                                                                        \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),           \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]), "+f"(d[o + 8]), "+f"(d[o + 9]),       \
      "+f"(d[o + 10]), "+f"(d[o + 11]), "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]),  \
      "+f"(d[o + 15]), "+f"(d[o + 16]), "+f"(d[o + 17]), "+f"(d[o + 18]), "+f"(d[o + 19]),  \
      "+f"(d[o + 20]), "+f"(d[o + 21]), "+f"(d[o + 22]), "+f"(d[o + 23]), "+f"(d[o + 24]),  \
      "+f"(d[o + 25]), "+f"(d[o + 26]), "+f"(d[o + 27]), "+f"(d[o + 28]), "+f"(d[o + 29]),  \
      "+f"(d[o + 30]), "+f"(d[o + 31])
#define WG_R32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R64_TAIL                                                                         \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, " \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x 128 f32) (+)= A (64 x 16, smem, K-major) . B (16 x 128, smem, K-major);
// acc = 0 overwrites d
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R32 WG_R64_TAIL
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d, 0), WG_D32(d, 32)
      : "l"(a), "l"(b), "r"(acc));
}
// d (64 x 64 NP f32) += A (64 x 16 bf16, registers) . B (16 x 64 NP, smem, MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R32 WG_R64_TAIL
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D32(d, 0), WG_D32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_D32
#undef WG_R32
#undef WG_R64_TAIL

// 2^x on the SFU, denormal results flushed to 0 (exp2f adds a rescale
// for them): probabilities below 2^-126 of the row's largest add nothing.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid: ceil(Sq / (128 / rep)) x KVH x B CTAs on one axis, the q tile
// slowest and reversed; kThreads threads.  NP 64-column panels (D <= 64 NP).
template <int NP, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                      int B, int Sq, int Skv, int H, int KVH, int D, int causal, int window,
                      int q_offset, float scale_log2) {
  using L = Layout<NP, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::bars;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * STAGES, bar_e = bar_v + 8 * STAGES;

  const int rep = H / KVH, bq = kRows / rep, rows = bq * rep;
  const int n_gb = KVH * B;
  const int tile = (Sq + bq - 1) / bq - 1 - (int)(blockIdx.x / n_gb);
  const int g = (int)(blockIdx.x % n_gb) % KVH, b = (int)(blockIdx.x % n_gb) / KVH;
  const int q0 = tile * bq;        // first query row (the TMA coordinate)
  const int p0 = q_offset + q0;   // and its position
  // the KV tiles that touch the CTA's band
  const int q_last = q_offset + min(q0 + bq, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int t_begin = (window ? max(0, p0 - window + 1) : 0) / kKeys;
  const int t_end = (k_end + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 8);  // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, NP * 128 * rows);
      for (int p = 0; p < NP; ++p)
        tma_load(base + L::q + p * kPanelBytes, &tm_q, bar_q, 64 * p, g * rep, q0, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(bar_e + 8 * s, (i / STAGES - 1) & 1);
        mbar_expect_tx(bar_k + 8 * s, NP * kPanelBytes);
        for (int p = 0; p < NP; ++p)
          tma_load(base + L::k + (s * NP + p) * kPanelBytes, &tm_k, bar_k + 8 * s, 64 * p, g,
                   t * kKeys, b);
        mbar_expect_tx(bar_v + 8 * s, NP * kPanelBytes);
        for (int p = 0; p < NP; ++p)
          tma_load(base + L::v + (s * NP + p) * kPanelBytes, &tm_v, bar_v + 8 * s, 64 * p, g,
                   t * kKeys, b);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    // this thread's rows of the accumulators: r0 and r0 + 8
    const int r0 = 64 * wg + 16 * warp + lane / 4;
    const int qp0 = p0 + r0 / rep, qp1 = p0 + (r0 + 8) / rep;
    // the warpgroup's positions, for telling edge tiles from interior ones
    const int wq_first = p0 + 64 * wg / rep, wq_last = p0 + (64 * wg + 63) / rep;
    const int hi0 = causal ? min(Skv, qp0 + 1) : Skv, hi1 = causal ? min(Skv, qp1 + 1) : Skv;
    const int lo0 = window ? qp0 - window + 1 : 0, lo1 = window ? qp1 - window + 1 : 0;
    const uint32_t q_addr = base + L::q + wg * 64 * 128;

    float o[32 * NP];
#pragma unroll
    for (int i = 0; i < 32 * NP; ++i) o[i] = 0.f;
    // each row's running max scaled by scale log2 e (ms, rounded) and sum
    float ms0 = -INFINITY, ms1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    mbar_wait(bar_q, 0);
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const int k0 = t * kKeys;
      const uint32_t k_addr = base + L::k + s * NP * kPanelBytes;
      const uint32_t v_addr = base + L::v + s * NP * kPanelBytes;

      // S = Q K^T
      float sc[64];
      mbar_wait(bar_k + 8 * s, parity);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NP; ++kk) {  // columns past D are zeros
        const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
        mma_ss_n128(sc, desc(q_addr + off, 16, 1024), desc(k_addr + off, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait();
      pin(sc);

      // mask the tiles that straddle an edge of the warpgroup's band
      if (k0 + kKeys > Skv || (causal && k0 + kKeys - 1 > wq_first) ||
          (window && k0 <= wq_last - window)) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * j + 2 * (lane % 4) + e;
            if (kpos >= hi0 || kpos < lo0) sc[4 * j + e] = -INFINITY;
            if (kpos >= hi1 || kpos < lo1) sc[4 * j + 2 + e] = -INFINITY;
          }
        }
      }

      // online softmax: the 4 threads of a quad hold one row's 128 keys
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      // The running max is kept scaled, one rounded product a tile
      // (__fmul_rn is never fused; rounding is monotonic, so it is the
      // scaled max of every tile so far), and the rescale is exactly
      // 2^(ms_old - ms_new), 1 while the max holds.  Rescaling by
      // ex2(m_old c - ms_new) instead, compiled as one FMA, kept m_old c's
      // rounding (up to half an ulp of ms: 4e-5 of p where m c ~ 2000) and
      // weighed the earlier tiles by it once more every tile.  A row with
      // no valid key yet keeps -inf and shifts by 0: its p are exp2(-inf) = 0.
      const float ns0 = fmaxf(ms0, __fmul_rn(mx0, scale_log2));
      const float ns1 = fmaxf(ms1, __fmul_rn(mx1, scale_log2));
      const float sh0 = ns0 == -INFINITY ? 0.f : ns0, sh1 = ns1 == -INFINITY ? 0.f : ns1;
      const float corr0 = ex2(ms0 - sh0), corr1 = ex2(ms1 - sh1);
      ms0 = ns0;
      ms1 = ns1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -sh0));
          sc[4 * j + 2 + e] = ex2(fmaf(sc[4 * j + 2 + e], scale_log2, -sh1));
          sum0 += sc[4 * j + e];
          sum1 += sc[4 * j + 2 + e];
        }
      }
      l0 = l0 * corr0 + sum0;  // this thread's share; the quad's is summed at the end
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int j = 0; j < 8 * NP; ++j) {
        o[4 * j] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }

      // P as the A fragments of the 8 16-key steps: register 4 kk + x
      // holds scores 8 kk + 2x and 8 kk + 2x + 1 (the S fragment's order)
      uint32_t p_hi[32], p_lo[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        p_hi[x] = pack_bf16(sc[2 * x], sc[2 * x + 1]);
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&p_hi[x]);
        p_lo[x] = pack_bf16(sc[2 * x] - __low2float(h), sc[2 * x + 1] - __high2float(h));
      }

      // O += P V
      mbar_wait(bar_v + 8 * s, parity);
      pin(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        mma_rs(o, p_hi + 4 * kk, desc(v_addr + kk * 2048, kPanelBytes, 1024));
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        mma_rs(o, p_lo + 4 * kk, desc(v_addr + kk * 2048, kPanelBytes, 1024));
      wg_commit();
      wg_wait();
      pin(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * s);
    }

    // epilogue: out = acc / max(l, 1e-30) in bf16, through this warpgroup's
    // own Q rows of shared memory (same 128-byte swizzle), then 16-byte
    // stores of the valid rows' D columns
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < 8 * NP; ++j) {
      const int off = L::q + (j / 8) * kPanelBytes + r0 * 128 + (((j % 8) ^ (r0 % 8)) * 16) +
                      (lane % 4) * 4;
      *reinterpret_cast<uint32_t*>(smem + off) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(smem + off + 8 * 128) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    const int chunks = D / 8;
    for (int idx = tid; idx < 64 * chunks; idx += 128) {
      const int r = 64 * wg + idx / chunks, c = idx % chunks;
      const int qrow = q0 + r / rep;
      if (r >= rows || qrow >= Sq) continue;
      const uint4 val = *reinterpret_cast<const uint4*>(
          smem + L::q + (c / 8) * kPanelBytes + r * 128 + (((c % 8) ^ (r % 8)) * 16));
      *reinterpret_cast<uint4*>(out + (((size_t)b * Sq + qrow) * H + g * rep + r % rep) * D +
                                8 * c) = val;
    }
  }
}

// One tile through the same TMA maps, descriptors and fragments, for
// tools/probe_prefill_kernels.py: s = q k^T (64 x 128, f32) from the
// shared-memory product, o = bf16(s) v (64 x 64 NP, f32) from the
// register-A product.  q (64, D), k and v (128, D) bf16; one warpgroup.
template <int NP>
__global__ void __launch_bounds__(128)
tile_probe(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, float* s_out, float* o_out) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_addr = base, k_addr = base + NP * kPanelBytes,
                 v_addr = base + 2 * NP * kPanelBytes, bar = base + 3 * NP * kPanelBytes;
  const int lane = threadIdx.x % 32, row = 16 * (threadIdx.x / 32) + lane / 4;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, NP * (64 * 128 + 2 * kPanelBytes));
    for (int p = 0; p < NP; ++p) {
      tma_load(q_addr + p * kPanelBytes, &tm_q, bar, 64 * p, 0, 0, 0);
      tma_load(k_addr + p * kPanelBytes, &tm_k, bar, 64 * p, 0, 0, 0);
      tma_load(v_addr + p * kPanelBytes, &tm_v, bar, 64 * p, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  float sc[64];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NP; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    mma_ss_n128(sc, desc(q_addr + off, 16, 1024), desc(k_addr + off, 16, 1024), kk > 0);
  }
  wg_commit();
  wg_wait();
  pin(sc);
  uint32_t p[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) p[x] = pack_bf16(sc[2 * x], sc[2 * x + 1]);
  float o[32 * NP];
#pragma unroll
  for (int i = 0; i < 32 * NP; ++i) o[i] = 0.f;
  pin(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) mma_rs(o, p + 4 * kk, desc(v_addr + kk * 2048, kPanelBytes, 1024));
  wg_commit();
  wg_wait();
  pin(o);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_out[(row + 8 * (e / 2)) * 128 + 8 * j + 2 * (lane % 4) + e % 2] = sc[4 * j + e];
#pragma unroll
  for (int j = 0; j < 8 * NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_out[(row + 8 * (e / 2)) * 64 * NP + 8 * j + 2 * (lane % 4) + e % 2] = o[4 * j + e];
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (so the library needs no -lcuda); null when it is not found.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A (B, S, heads, D) bf16 tensor as a 4-D map (D, heads, S, B), 128-byte
// swizzle, box (64, box_heads, box_rows, 1); elements outside read as 0.
int encode(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, int box_heads,
           int box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return kEncodeError;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_heads, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + (int)res;
}

template <int NP, int STAGES>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv, int H,
           int KVH, int D, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const int rep = H / KVH, bq = kRows / rep;
  CUtensorMap tq, tk, tv;
  int code = encode(&tq, q, B, Sq, H, D, rep, bq);
  if (!code) code = encode(&tk, k, B, Skv, KVH, D, 1, kKeys);
  if (!code) code = encode(&tv, v, B, Skv, KVH, D, 1, kKeys);
  if (code) return code;
  const auto kernel = flash_attention_wgmma<NP, STAGES>;
  const int smem = Layout<NP, STAGES>::bytes;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)((Sq + bq - 1) / bq) * KVH * B;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out),
                                                     B, Sq, Skv, H, KVH, D, causal, window,
                                                     q_offset, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_probe(const void* q, const void* k, const void* v, float* s_out, float* o_out, int D,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int code = encode(&tq, q, 1, 64, 1, D, 1, 64);
  if (!code) code = encode(&tk, k, 1, 128, 1, D, 1, kKeys);
  if (!code) code = encode(&tv, v, 1, 128, 1, D, 1, kKeys);
  if (code) return code;
  const int smem = 3 * NP * kPanelBytes + 8 + 1024;
  const cudaError_t err =
      cudaFuncSetAttribute(tile_probe<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tile_probe<NP><<<1, 128, smem, stream>>>(tq, tk, tv, s_out, o_out);
  return (int)cudaGetLastError();
}

}  // namespace wg

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  q and out share q's dtype, k
// and v theirs; bf16 q with bf16 k/v is flash_attention_wgmma's and is
// refused here.  Shapes: q, out (B, Sq, H, D); k, v (B, Skv, KVH, D); all
// contiguous and 16-byte aligned.  H is a multiple of KVH with
// H / KVH <= 64; D a multiple of 8, at most 128; window 0 = none; query row
// s stands at position q_offset + s (q_offset >= 0).
int flash_attention(int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
                    void* out, int B, int Sq, int Skv, int H, int KVH, int D, int causal,
                    int window, int q_offset, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (KVH < 1 || H % KVH != 0 || H / KVH > kRows || D < 8 || D % 8 != 0 || D > kMaxD ||
      window < 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
#define FA_CASE(TQ, TKV) \
  return launch<TQ, TKV>(q, k, v, out, B, Sq, Skv, H, KVH, D, causal, window, q_offset, scale, \
                         st)
  if (q_dtype == 0 && kv_dtype == 0) FA_CASE(float, float);
  if (q_dtype == 0 && kv_dtype == 1) FA_CASE(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 0) FA_CASE(__nv_bfloat16, float);
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

// bf16 q, k, v and out, the shapes and limits of flash_attention.  Skv = 0
// writes zeros (no key is valid), as the plain version does.
int flash_attention_wgmma(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                          int Skv, int H, int KVH, int D, int causal, int window, int q_offset,
                          float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (KVH < 1 || H % KVH != 0 || H / KVH > kRows || D < 8 || D % 8 != 0 || D > kMaxD ||
      window < 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  if (Skv == 0) return (int)cudaMemsetAsync(out, 0, (size_t)B * Sq * H * D * 2, st);
  if (D <= 64)
    return wg::launch<1, 4>(q, k, v, out, B, Sq, Skv, H, KVH, D, causal, window, q_offset, scale,
                            st);
  return wg::launch<2, 2>(q, k, v, out, B, Sq, Skv, H, KVH, D, causal, window, q_offset, scale,
                          st);
}

// The one-tile probe (wg::tile_probe): q (64, D), k and v (128, D) bf16;
// s (64, 128) and o (64, 64 ceil(D / 64)) f32.
int flash_attention_wgmma_probe(const void* q, const void* k, const void* v, void* s, void* o,
                                int D, void* stream) {
  if (D < 8 || D % 8 != 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float *fs = static_cast<float*>(s), *fo = static_cast<float*>(o);
  return D <= 64 ? wg::launch_probe<1>(q, k, v, fs, fo, D, st)
                 : wg::launch_probe<2>(q, k, v, fs, fo, D, st);
}

const char* flash_attention_error_string(int code) {
  if (code >= wg::kEncodeError)
    return "cuTensorMapEncodeTiled failed (the code less 20000 is the CUresult)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
