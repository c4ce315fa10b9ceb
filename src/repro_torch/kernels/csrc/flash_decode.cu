// Split-KV flash decode for Hopper (sm_90a): one query token per row
// attends a KV cache, grouped-query attention, online softmax, in one
// launch.
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
// the card's balance point.  The bytes of the valid cache prefix bound it
// (sum_b kv_len_b * KVH * D * 2 * itemsize): 11 MB, 3.4 us, at granite's
// serve step.  At that size what the card can reach is set by how many
// loads are in flight at once, by the launch, and by the fixed work of
// each CTA (its prologue, its epilogue and the merge of the splits).
//
// What the design does about it.
// (1) One launch a call.  The KV axis is split across CTAs (grid splits x
//     KVH x B, and x head groups of 16 in the bf16 variant): each reads
//     every K/V tile of its share once for all the q heads of its group.
//     Tiles go to splits round-robin over the VALID tiles of the row, so
//     the splits of a row share its work evenly whatever kv_len is.  The
//     splits of one (row, kv head, head group) are one thread-block
//     cluster (at most 8): each CTA leaves its partial (m, l, acc) in its
//     own shared memory, and after a cluster barrier the CTAs merge them
//     through distributed shared memory, each CTA a slice of the outputs,
//     over the splits in rank order (M = max m_s, L = sum l_s e^(m_s - M),
//     acc = sum acc_s e^(m_s - M)); a second barrier keeps every partial
//     alive until it has been read.  No scratch in device memory, no
//     counters, no float atomics: a call's result does not depend on
//     which CTA finished first, so two calls on the same inputs agree to
//     the bit, and nothing on the host changes between calls but the
//     arguments (a CUDA graph can capture one).
// (2) A ring of K/V tiles in shared memory filled by cp.async (16-byte
//     copies, zero-filled past kv_len): while a tile is computed the next
//     stages-1 are in flight.  The wrapper picks fewer splits than before
//     (two CTAs an SM instead of four, at most 8 a cluster), so a CTA walks
//     several tiles and the ring holds them all in flight at granite's
//     serve step.
// (3) bf16 q on a bf16 cache (the serve path): tensor cores,
//     mma.sync.m16n8k16 with f32 accumulation.  A CTA holds up to 16 q
//     heads as the 16 rows of the A tile; each of its 4 warps takes 16 of
//     the tile's 64 keys and runs its own online softmax over them, so the
//     warps need no barrier between their products; their (m, l, acc)
//     merge once, after the last tile.  S = q K^T takes raw bf16 operands:
//     exact products.  P V needs P (f32) in bf16: P is split into hi =
//     bf16(P) and lo = bf16(P - hi) and multiplied twice, which keeps P to
//     ~2^-17 of itself (one rounding would cost up to 2^-9).  With rep <= 8
//     the A tile's rows 8-15 are padding, and the softmax skips them.
// (4) Every other dtype pair (f32 q on a bf16 cache, as the cross path
//     runs; f32 on f32; bf16 q on an f32 cache): CUDA-core FMAs, 32-key
//     tiles, all rep heads in one CTA, scores, softmax and the accumulator
//     in f32, as the first version of this kernel did.
//
// The entry point returns cudaGetLastError() (or the first error of a
// runtime call) as an int; the Python wrapper raises when it is non-zero.
// flash_decode_kernels_launched() returns how many device kernels the
// library has launched so far, counted beside each launch: kernels per
// call without a tracer.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

std::atomic<long long> g_kernels{0};  // device kernels launched

constexpr int kThreads = 128;
constexpr int kMmaTile = 64;      // keys per tile, tensor-core variant (16 a warp)
constexpr int kMmaHeads = 16;     // q heads a CTA holds, tensor-core variant
constexpr int kSimtTile = 32;     // keys per tile, FMA variant
constexpr int kMaxAcc = 16;       // FMA variant: accumulator elements a thread
constexpr int kMaxStages = 4;
constexpr int kMaxSplits = 8;     // splits of the KV axis: one portable cluster
constexpr size_t kRingBudget = 112 * 1024;  // ring bytes aimed at a CTA
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most n of this thread's copy groups are pending (n < kMaxStages).
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0) asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::);
  else asm volatile("cp.async.wait_group 2;\n" ::);
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
// Two f32 as a bf16 pair (x in the low half), and the pair of what is left.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack_rest(float x, float y, uint32_t hi) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  return pack_bf16(x - __low2float(h), y - __high2float(h));
}

// Dot product of one 16-byte chunk of a K row with q (f32, shared).
__device__ __forceinline__ float dot16(const float* kc, const float* q) {
  const float4 k4 = *reinterpret_cast<const float4*>(kc);
  return k4.x * q[0] + k4.y * q[1] + k4.z * q[2] + k4.w * q[3];
}
__device__ __forceinline__ float dot16(const bf16* kc, const float* q) {
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

// The tiles of a row's valid prefix that split `split` of `n_split` takes
// (t = split, split + n_split, ...): how many, and where the i-th starts.
struct Share {
  int len, split, n_split, tile, mine;
  __device__ Share(int len_, int split_, int n_split_, int tile_)
      : len(len_), split(split_), n_split(n_split_), tile(tile_) {
    const int n_tiles = (len + tile - 1) / tile;
    mine = split < n_tiles ? (n_tiles - split + n_split - 1) / n_split : 0;
  }
  __device__ int first_key(int i) const { return (split + i * n_split) * tile; }
  __device__ int keys(int i) const { return min(tile, len - first_key(i)); }
};

// This thread's part of copying a tile of rows of D elements: the 16-byte
// column e of rows j, j + step, ... (threads past rows-per-pass x columns
// copy nothing).  Worked out once, so that a tile's copies cost no division.
template <typename T>
struct TileLane {
  int j, e, step;
  __device__ TileLane(int D) {
    constexpr int vec = 16 / sizeof(T);
    const int vecs = D / vec;
    step = kThreads / vecs;
    j = threadIdx.x < step * vecs ? threadIdx.x / vecs : 1 << 30;
    e = (threadIdx.x % vecs) * vec;
  }
};

// Issue the copies of tile i of `sh` (`row` elements apart in device
// memory, `ld` apart in the slot) and commit them as one group; past the
// share only an empty group is committed.
template <typename T>
__device__ __forceinline__ void load_tile(const Share& sh, int i, const TileLane<T>& tl,
                                          const T* kb, const T* vb, size_t row, T* ks, T* vs,
                                          int ld) {
  if (i < sh.mine) {
    const int k0 = sh.first_key(i), nk = sh.keys(i);
    for (int j = tl.j; j < sh.tile; j += tl.step) {
      const bool ok = j < nk;
      const size_t off = (size_t)(ok ? k0 + j : 0) * row + tl.e;
      cp_async16(ks + j * ld + tl.e, kb + off, ok);
      cp_async16(vs + j * ld + tl.e, vb + off, ok);
    }
  }
  cp_async_commit();
}

// After every CTA of the cluster (the splits of one group of nh heads,
// flat heads bh0 .. bh0 + nh - 1 = b*H + h) left its partial in its own
// shared memory -- m and l (nh each), then acc (nh x D) -- merge them:
// CTA `rank` takes the outputs rank*kThreads + tid, stepping by the
// cluster's threads, and sums over the splits in rank order.
template <typename TQ>
__device__ void merge_splits(const float* mine, int nh, int D, size_t bh0, TQ* out, float* m_out,
                             float* l_out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = cluster.num_blocks(), rank = cluster.block_rank();
  cluster.sync();  // every partial is written
  for (int e = rank * kThreads + threadIdx.x; e < nh * D; e += n_split * kThreads) {
    const int r = e / D, d = e - r * D;
    float m[kMaxSplits], l[kMaxSplits], a[kMaxSplits];
    float M = kNegInf;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < n_split) {
        const float* part = cluster.map_shared_rank(const_cast<float*>(mine), sp);
        m[sp] = part[r];
        l[sp] = part[nh + r];
        a[sp] = part[2 * nh + r * D + d];
        M = fmaxf(M, m[sp]);
      }
    float L = 0.f, acc = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < n_split) {
        const float w = expf(m[sp] - M);
        L += l[sp] * w;
        acc += a[sp] * w;
      }
    out[(bh0 + r) * D + d] = from_f32<TQ>(acc / fmaxf(L, 1e-30f));
    if (d == 0) {
      m_out[bh0 + r] = M;
      l_out[bh0 + r] = L;
    }
  }
  cluster.sync();  // no CTA leaves while its partial may still be read
}

// ---------------------------------------------------- tensor-core variant

// The row length of the bf16 tiles: D rounded up to 16 (the depth of a
// product; columns past D are zero), plus 8 so that rows are an odd number
// of 16-byte units apart and ldmatrix hits distinct banks.
__host__ __device__ inline int mma_ld(int D) { return ((D + 15) & ~15) + 8; }

size_t mma_stage_bytes(int D) { return 2 * (size_t)kMmaTile * mma_ld(D) * sizeof(bf16); }

// grid (splits, KVH * head groups, B), the splits of each (group, row) one
// cluster.  DMAX: D rounded up to 64, 128 or 256; TO: out's type, bf16 or
// (for a caller that merges partials of its own) float.
template <int DMAX, typename TO>
__global__ void __launch_bounds__(kThreads)
flash_decode_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ kv_len, int S, int H,
                 int KVH, int D, int stages, float scale, TO* __restrict__ out,
                 float* __restrict__ m_out,
                 float* __restrict__ l_out) {
  const int rep = H / KVH, groups = gridDim.y / KVH;
  const int g = blockIdx.y / groups, hg = blockIdx.y - g * groups, b = blockIdx.z;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int nh = min(kMmaHeads, rep - hg * kMmaHeads);
  const size_t bh0 = (size_t)b * H + g * rep + hg * kMmaHeads;
  const Share sh(min(max(kv_len[b], 0), S), split, n_split, kMmaTile);
  const int dk = (D + 15) & ~15, ld = mma_ld(D);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // (16, ld): rows past nh zero
  bf16* ring = q_s + kMmaHeads * ld;          // stages x (K (64, ld), V (64, ld))
  const int stage = 2 * kMmaTile * ld;

  for (int e = tid; e < kMmaHeads * (ld / 8); e += kThreads) {  // 16 bytes at a time
    const int r = e / (ld / 8), c = (e - r * (ld / 8)) * 8;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u);
    if (r < nh && c < D) qv = *reinterpret_cast<const uint4*>(q + (bh0 + r) * D + c);
    *reinterpret_cast<uint4*>(q_s + r * ld + c) = qv;
  }
  if (dk > D)  // the K columns the products read past D stay zero
    for (int e = tid; e < stages * kMmaTile * (dk - D); e += kThreads) {
      const int j = e / (dk - D);
      ring[(j / kMmaTile) * stage + (j % kMmaTile) * ld + D + e % (dk - D)] =
          __float2bfloat16(0.f);
    }

  const size_t row = (size_t)KVH * D;
  const bf16* kb = k + (size_t)b * S * row + (size_t)g * D;
  const bf16* vb = v + (size_t)b * S * row + (size_t)g * D;
  const TileLane<bf16> tl(D);
  for (int i = 0; i < stages - 1; ++i)
    load_tile(sh, i, tl, kb, vb, row, ring + i * stage, ring + i * stage + kMmaTile * ld, ld);

  // q as A tiles, kept in registers where D <= 128 (re-read per tile above)
  constexpr int kQf = DMAX <= 128 ? DMAX / 16 : 1;
  uint32_t qf[kQf][4];
  if constexpr (DMAX <= 128) {
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kQf; ++kk)
      if (kk * 16 < dk) ldmatrix_x4(qf[kk], q_s + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
  }
  // this thread's rows of the warp's 16 x D accumulator: heads r0, r0 + 8
  const int r0 = lane >> 2, c0 = 2 * (lane & 3);
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float o[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int i = 0; i < sh.mine; ++i) {
    cp_async_wait(stages - 2);
    __syncthreads();  // tile i landed; every warp is done with tile i - 1's slot
    {
      const int nxt = i + stages - 1, slot = nxt % stages;
      load_tile(sh, nxt, tl, kb, vb, row, ring + slot * stage,
                ring + slot * stage + kMmaTile * ld, ld);
    }
    const bf16* ks = ring + (i % stages) * stage;
    const bf16* vs = ks + kMmaTile * ld;
    const int kw0 = warp * 16, nk = sh.keys(i);
    if (kw0 >= nk) continue;  // this warp's 16 keys are past kv_len

    // s (16 heads x 16 keys) = q K^T: two n8 tiles of keys
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < dk) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (kw0 + (lane & 7) + (lane >> 4) * 8) * ld + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        if constexpr (DMAX <= 128) {
          mma_bf16(s[0], qf[kk], bk[0], bk[1]);
          mma_bf16(s[1], qf[kk], bk[2], bk[3]);
        } else {
          uint32_t a[4];
          ldmatrix_x4(a, q_s + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
          mma_bf16(s[0], a, bk[0], bk[1]);
          mma_bf16(s[1], a, bk[2], bk[3]);
        }
      }
    }
    // online softmax over the warp's keys, rows r0 (e = 0, 1) and r0 + 8
    // (e = 2, 3); the rows r0 + 8 hold heads only past the eighth, so with
    // rep <= 8 (the serve path's 4) their half is skipped, warp-uniformly
    const int halves = nh > 8 ? 2 : 1;
    float mx[2] = {kNegInf, kNegInf}, corr[2] = {1.f, 1.f}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h >= halves) break;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const bool ok = kw0 + n * 8 + c0 + (e & 1) < nk;
          s[n][e] = ok ? s[n][e] * scale : kNegInf;
          mx[h] = fmaxf(mx[h], s[n][e]);
        }
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      corr[h] = __expf(m_r[h] - m_new);
      m_r[h] = m_new;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const bool ok = kw0 + n * 8 + c0 + (e & 1) < nk;
          s[n][e] = ok ? __expf(s[n][e] - m_new) : 0.f;
          sum[h] += s[n][e];
        }
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_r[h] = l_r[h] * corr[h] + sum[h];
    }
    if (halves == 1) {
      s[0][2] = s[0][3] = s[1][2] = s[1][3] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    uint32_t vt[DMAX / 16][4];
    // P as the A tile (16 heads x 16 keys), hi + lo
    uint32_t ph[4], pl[4];
    ph[0] = pack_bf16(s[0][0], s[0][1]);
    ph[1] = pack_bf16(s[0][2], s[0][3]);
    ph[2] = pack_bf16(s[1][0], s[1][1]);
    ph[3] = pack_bf16(s[1][2], s[1][3]);
    pl[0] = pack_rest(s[0][0], s[0][1], ph[0]);
    pl[1] = pack_rest(s[0][2], s[0][3], ph[1]);
    pl[2] = pack_rest(s[1][0], s[1][1], ph[2]);
    pl[3] = pack_rest(s[1][2], s[1][3], ph[3]);
    // o += P V: V (16 keys x D) as B; every hi product, then every lo one
#pragma unroll
    for (int n = 0; n < DMAX / 8; n += 2) {
      if (n * 8 < D) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kw0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n * 8 +
                                  (lane >> 4) * 8);
        mma_bf16(o[n], ph, bv[0], bv[1]);
        if ((n + 1) * 8 < D) mma_bf16(o[n + 1], ph, bv[2], bv[3]);
        vt[n / 2][0] = bv[0];
        vt[n / 2][1] = bv[1];
        vt[n / 2][2] = bv[2];
        vt[n / 2][3] = bv[3];
      }
    }
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
      if (n * 8 < D) mma_bf16(o[n], pl, vt[n / 2][(n & 1) * 2], vt[n / 2][(n & 1) * 2 + 1]);
  }
  cp_async_wait(0);
  __syncthreads();  // the ring is free: merge the four warps there

  float* red_m = reinterpret_cast<float*>(ring);  // (4, 16); ring bytes >= 640 + 320 D

  float* red_l = red_m + 4 * kMmaHeads;           // (4, 16)
  float* red_o = red_l + 4 * kMmaHeads;           // (4, 16, D)
  if ((lane & 3) == 0) {
    red_m[warp * kMmaHeads + r0] = m_r[0];
    red_m[warp * kMmaHeads + r0 + 8] = m_r[1];
    red_l[warp * kMmaHeads + r0] = l_r[0];
    red_l[warp * kMmaHeads + r0 + 8] = l_r[1];
  }
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
    if (n * 8 < D)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red_o[(warp * kMmaHeads + r0 + (e >> 1) * 8) * D + n * 8 + c0 + (e & 1)] = o[n][e];
  __syncthreads();
  float* mine = red_o + 4 * kMmaHeads * D;         // this CTA's m, l (nh), acc (nh, D)
  for (int e = tid; e < nh * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    float M = kNegInf;
    for (int w = 0; w < 4; ++w) M = fmaxf(M, red_m[w * kMmaHeads + r]);
    float a = 0.f, L = 0.f;
    for (int w = 0; w < 4; ++w) {
      const float wt = expf(red_m[w * kMmaHeads + r] - M);
      a += red_o[(w * kMmaHeads + r) * D + d] * wt;
      L += red_l[w * kMmaHeads + r] * wt;
    }
    mine[2 * nh + e] = a;
    if (d == 0) {
      mine[r] = M;
      mine[nh + r] = L;
    }
  }
  merge_splits<TO>(mine, nh, D, bh0, out, m_out, l_out);
}

// ------------------------------------------------------------ FMA variant

__host__ __device__ inline size_t simt_head_bytes(int rep, int D) {
  const size_t head = ((size_t)rep * D + (size_t)rep * kSimtTile + 3 * (size_t)rep) * sizeof(float);
  return (head + 127) & ~(size_t)127;
}
size_t simt_stage_bytes(int D, int kv_size) {
  return 2 * (size_t)kSimtTile * (D + 16 / kv_size) * kv_size;
}

// grid (splits, KVH, B), the splits of each (kv head, row) one cluster.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
flash_decode_simt(const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
                  const int* __restrict__ kv_len, int S, int H, int KVH, int D, int stages,
                  float scale, TQ* __restrict__ out, float* __restrict__ m_out,
                  float* __restrict__ l_out) {
  const int split = blockIdx.x, n_split = gridDim.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = H / KVH;
  const Share sh(min(max(kv_len[b], 0), S), split, n_split, kSimtTile);
  constexpr int vec = 16 / sizeof(TKV);          // elements per 16-byte copy
  const int ld = D + vec;                        // padded shared row

  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);   // (rep, D)
  float* p_s = q_s + rep * D;                    // (rep, kSimtTile) scores, then p
  float* m_s = p_s + rep * kSimtTile;            // (rep,) running max
  float* l_s = m_s + rep;                        // (rep,) running sum
  float* c_s = l_s + rep;                        // (rep,) this tile's rescale
  TKV* ring = reinterpret_cast<TKV*>(smem + simt_head_bytes(rep, D));
  const int stage = 2 * kSimtTile * ld;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh0 = (size_t)b * H + g * rep;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = to_f32(q[bh0 * D + i]);
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int n_acc = (rep * D + kThreads - 1) / kThreads;
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  const size_t row = (size_t)KVH * D;
  const TKV* kb = k + (size_t)b * S * row + (size_t)g * D;
  const TKV* vb = v + (size_t)b * S * row + (size_t)g * D;
  const TileLane<TKV> tl(D);
  for (int i = 0; i < stages - 1; ++i)
    load_tile(sh, i, tl, kb, vb, row, ring + i * stage, ring + i * stage + kSimtTile * ld, ld);

  for (int i = 0; i < sh.mine; ++i) {
    cp_async_wait(stages - 2);
    __syncthreads();
    {
      const int nxt = i + stages - 1, slot = nxt % stages;
      load_tile(sh, nxt, tl, kb, vb, row, ring + slot * stage,
                ring + slot * stage + kSimtTile * ld, ld);
    }
    const TKV* k_s = ring + (i % stages) * stage;
    const TKV* v_s = k_s + kSimtTile * ld;
    const int nk = sh.keys(i);

    // scores: thread -> key j, heads r = warp, warp + 4, ...
    {
      const int j = lane;
      for (int r = warp; r < rep; r += kThreads / 32) {
        float sc = kNegInf;
        if (j < nk) {
          float dot = 0.f;
          for (int c = 0; c < D; c += vec) dot += dot16(k_s + j * ld + c, q_s + r * D + c);
          sc = dot * scale;
        }
        p_s[r * kSimtTile + j] = sc;
      }
    }
    __syncwarp();
    // online softmax: one warp per head, one key per lane (the warp that
    // wrote the head's scores)
    for (int r = warp; r < rep; r += kThreads / 32) {
      const float sc = p_s[r * kSimtTile + lane];
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = lane < nk ? expf(sc - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[r * kSimtTile + lane] = p;
      __syncwarp();
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
    for (int i2 = 0; i2 < kMaxAcc; ++i2) {
      const int e = tid + i2 * kThreads;
      if (i2 < n_acc && e < rep * D) {
        const int r = e / D, d = e - r * D;
        const float* pr = p_s + r * kSimtTile;
        float a = 0.f;
        for (int j = 0; j < nk; ++j) a += pr[j] * to_f32(v_s[j * ld + d]);
        acc[i2] = acc[i2] * c_s[r] + a;
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();

  float* mine = reinterpret_cast<float*>(ring);  // m, l (rep), acc (rep, D)
  for (int r = tid; r < rep; r += kThreads) {
    mine[r] = m_s[r];
    mine[rep + r] = l_s[r];
  }
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (i < n_acc && e < rep * D) mine[2 * rep + e] = acc[i];
  }
  merge_splits<TQ>(mine, rep, D, bh0, out, m_out, l_out);
}

int ring_stages(size_t stage_bytes) {
  const size_t n = kRingBudget / stage_bytes;
  return n < 2 ? 2 : (n > kMaxStages ? kMaxStages : (int)n);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v;
  const int* kv_len;
  int B, S, H, KVH, D, n_split;
  float scale;
  void* out;
  float *m_out, *l_out;
  cudaStream_t stream;
};

// Launch `kernel` on grid (splits, groups, B) with the splits of each
// (group, row) as one cluster.
template <typename... Params, typename... As>
int launch_clusters(void (*kernel)(Params...), const Args& a, int groups, size_t smem,
                    As... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, groups, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err == cudaSuccess) ++g_kernels;
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int DMAX, typename TO>
int launch_mma(const Args& a) {
  const int rep = a.H / a.KVH, groups = (rep + kMmaHeads - 1) / kMmaHeads;
  const int stages = ring_stages(mma_stage_bytes(a.D));
  const size_t smem = (size_t)kMmaHeads * mma_ld(a.D) * sizeof(bf16) + stages * mma_stage_bytes(a.D);
  return launch_clusters(flash_decode_mma<DMAX, TO>, a, a.KVH * groups, smem,
                         static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                         static_cast<const bf16*>(a.v), a.kv_len, a.S, a.H, a.KVH, a.D, stages,
                         a.scale, static_cast<TO*>(a.out), a.m_out, a.l_out);
}

template <typename TO>
int launch_mma_d(const Args& a) {
  if (a.D <= 64) return launch_mma<64, TO>(a);
  if (a.D <= 128) return launch_mma<128, TO>(a);
  return launch_mma<256, TO>(a);
}

template <typename TQ, typename TKV>
int launch_simt(const Args& a) {
  const int rep = a.H / a.KVH;
  const int stages = ring_stages(simt_stage_bytes(a.D, sizeof(TKV)));
  const size_t ring = stages * simt_stage_bytes(a.D, sizeof(TKV));
  const size_t partial = (size_t)rep * (a.D + 2) * sizeof(float);  // left in the ring at the end
  const size_t smem = simt_head_bytes(rep, a.D) + (ring > partial ? ring : partial);
  return launch_clusters(flash_decode_simt<TQ, TKV>, a, a.KVH, smem,
                         static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
                         static_cast<const TKV*>(a.v), a.kv_len, a.S, a.H, a.KVH, a.D, stages,
                         a.scale, static_cast<TQ*>(a.out), a.m_out, a.l_out);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  k and v share the cache's
// dtype; out has q's, except that bf16 q on a bf16 cache may write a
// float32 out (out_dtype 0: its last rounding left to a caller that
// merges partials).  bf16 q on a bf16 cache takes the tensor-core
// variant, every other pair the FMA variant.  Shapes: q, out (B, H, D);
// k, v (B, S, KVH, D); kv_len (B,) int32; m_out, l_out (B, H).  Every
// tensor is contiguous; D is a multiple of 8, at most 256, with
// rep * D <= 2048; 1 <= n_split <= 8 (one cluster of splits).
int flash_decode(int q_dtype, int kv_dtype, int out_dtype, const void* q, const void* k,
                 const void* v, const int* kv_len, int B, int S, int H, int KVH, int D,
                 int n_split, float scale, void* out, float* m_out, float* l_out, void* stream) {
  if (KVH < 1 || H % KVH != 0 || D % 8 != 0 || D > 256 || (H / KVH) * D > kThreads * kMaxAcc ||
      n_split < 1 || n_split > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  const Args a{q, k, v, kv_len, B, S, H, KVH, D, n_split, scale, out, m_out, l_out,
               (cudaStream_t)stream};
  if (q_dtype == 1 && kv_dtype == 1)
    return out_dtype == 0 ? launch_mma_d<float>(a) : launch_mma_d<bf16>(a);
  if (out_dtype != q_dtype) return (int)cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0) return launch_simt<float, float>(a);
  if (q_dtype == 0 && kv_dtype == 1) return launch_simt<float, bf16>(a);
  if (q_dtype == 1 && kv_dtype == 0) return launch_simt<bf16, float>(a);
  return (int)cudaErrorInvalidValue;
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

long long flash_decode_kernels_launched() { return g_kernels.load(); }

}  // extern "C"
