// Max-min progressive filling and loss/DCQCN rate factors for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the reference package:
//
//   maxmin_fill   <- src/repro/kernels/maxmin.py:_round_kernel (one round,
//                    launched by maxmin_round_pallas) together with the
//                    lax.while_loop of maxmin_rates that repeats it;
//   loss_factors  <- src/repro/kernels/maxmin.py:_loss_kernel (launched by
//                    loss_factors_pallas).
//
// The plain PyTorch versions beside them are
// src/repro_torch/kernels/ref.py (maxmin_round_reference,
// maxmin_rates_reference, loss_factors_reference).
//
// Layout.  Every call solves B independent lanes (the reference's vmap
// axis).  Lane b owns a (F, H) int32 matrix of LOCAL link ids in [0, Lc):
// the caller renumbers each lane's links into a compact range at pack
// time, and id Lc-1 is the sentinel link with capacity +inf that pads
// short rows.  Capacities are (B, Lc) (cap_stride = Lc) or one shared
// (Lc,) vector (cap_stride = 0).  Per-flow vectors are (B, F).
//
// What bounds these kernels on an H100.  Both read each link id a few
// times per round and do a handful of flops per id: by bytes and flops
// alike the card could finish a round in well under a microsecond.  What
// costs is latency: the phases of a round depend on each other (demand ->
// share -> bottleneck -> freeze -> subtract), so each round is a chain of
// barriers, and a launch costs microseconds.  The design therefore
// (1) runs the whole filling loop in ONE launch, rounds included, ending
// on a device-side "no live flow" test with no host sync per round;
// (2) gives each lane one CTA whose demand / remaining-capacity / used
// vectors live in shared memory when the lane's compact link range fits
// (maxmin_fill_lane), so a round is five __syncthreads() apart; and
// (3) for a lane too large for shared memory (a 16k-host fat tree's
// unicast mesh: ~8k-32k flows over tens of thousands of links) spreads
// one lane over every SM with a cooperative launch and grid-wide barriers
// between phases (maxmin_fill_grid), keeping the vectors in global
// memory (they stay in the 50 MB L2).
//
// Exactness.  Demand is counted with int32 atomics, so the freeze set is
// exact.  The frozen bandwidth subtracted from a link is the bottleneck
// b added once per newly frozen flow crossing it; the addends are all
// equal, so the atomic order cannot change the sum, and the result is
// bit-identical to the plain version's index_add_.  The loss kernel's
// per-link utilization sums different rates with atomics, so its last bit
// may differ from run to run; the build passes -fmad=false so every other
// expression rounds as the plain version's separate PyTorch ops do.
//
// Every entry point returns cudaGetLastError() (or the first error of a
// runtime call) as an int; the Python wrapper raises when it is non-zero.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ T inf_of();
template <> __device__ __forceinline__ float inf_of<float>() { return __int_as_float(0x7f800000); }
template <> __device__ __forceinline__ double inf_of<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

template <typename T> __device__ __forceinline__ T tmin(T a, T b) { return b < a ? b : a; }
template <typename T> __device__ __forceinline__ T tmax(T a, T b) { return b > a ? b : a; }
__device__ __forceinline__ float tsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double tsqrt(double v) { return sqrt(v); }

// Order-preserving integer image of a non-negative float (for atomicMin).
__device__ __forceinline__ long long ordered(float v) { return (long long)__float_as_int(v); }
__device__ __forceinline__ long long ordered(double v) { return __double_as_longlong(v); }
template <typename T> __device__ __forceinline__ T from_ordered(long long v);
template <> __device__ __forceinline__ float from_ordered<float>(long long v) {
  return __int_as_float((int)v);
}
template <> __device__ __forceinline__ double from_ordered<double>(long long v) {
  return __longlong_as_double(v);
}

// Min over the G lanes of a sub-warp group (G a power of two <= 32).
template <typename T> __device__ __forceinline__ T group_min(T v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v = tmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
template <typename T> __device__ __forceinline__ T group_max(T v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v = tmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions; every thread gets the result.
template <typename T> __device__ T block_min(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v = tmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < nwarps; ++w) r = tmin(r, red[w]);
  return r;
}

__device__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < nwarps; ++w) r += red[w];
  return r;
}

// ------------------------------------------------------------ maxmin_fill
//
// One round, as maxmin_round_reference computes it:
//   cnt[l]   = number of live (unfrozen) flows crossing l
//   share[l] = cnt > 0 ? cap_rem[l] / cnt : inf
//   tight[f] = min over f's links of share;  b = min over live f of tight
//   newly    = live & tight <= b * (1 + tol): rate b, frozen
//   cap_rem  = max(cap_rem - (b per newly frozen flow on the link), 0)
// repeated while some flow is live and the round index is <= bound.
//
// Flows are walked by sub-warp groups of G threads (G = min(32, H)
// rounded up to a power of two); the iteration count is uniform over the
// block (grid), so the warp shuffles always see every lane.

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxmin_fill_lane(const int* __restrict__ fl, int F, int H, const T* __restrict__ cap,
                 long long cap_stride, int Lc, T* __restrict__ rates, T* __restrict__ frozen,
                 T* __restrict__ cap_out, T* __restrict__ tight, int bound, T onetol,
                 int floor_rates, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_cap = reinterpret_cast<T*>(smem);
  T* s_used = s_cap + Lc;
  int* s_cnt = reinterpret_cast<int*>(s_used + Lc);
  __shared__ T red_t[32];
  __shared__ int red_i[32];

  const long long lane = blockIdx.x;
  fl += lane * F * H;
  cap += lane * cap_stride;
  rates += lane * F;
  frozen += lane * F;
  tight += lane * F;
  cap_out += lane * Lc;

  for (int l = threadIdx.x; l < Lc; l += blockDim.x) {
    s_cap[l] = cap[l];
    s_used[l] = T(0);
    s_cnt[l] = 0;
  }
  __syncthreads();

  const int per_block = blockDim.x / G;
  const int g = threadIdx.x / G, gl = threadIdx.x % G;
  const int iters = (F + per_block - 1) / per_block;
  const T inf = inf_of<T>();

  for (int it = 0;; ++it) {
    // demand of the live flows
    int my_live = 0;
    for (int k = 0; k < iters; ++k) {
      const int f = g + k * per_block;
      if (f < F && frozen[f] < T(0.5)) {
        if (gl == 0) ++my_live;
        for (int h = gl; h < H; h += G) atomicAdd(&s_cnt[fl[(long long)f * H + h]], 1);
      }
    }
    const int live = block_sum(my_live, red_i);
    if (live == 0 || it > bound) break;

    // tightest share per flow and the bottleneck b
    T my_min = inf;
    for (int k = 0; k < iters; ++k) {
      const int f = g + k * per_block;
      T t = inf;
      if (f < F) {
        for (int h = gl; h < H; h += G) {
          const int l = fl[(long long)f * H + h];
          const int c = s_cnt[l];
          t = tmin(t, c > 0 ? s_cap[l] / T(c) : inf);
        }
      }
      t = group_min(t, G);
      if (f < F && gl == 0) {
        tight[f] = t;
        if (frozen[f] < T(0.5)) my_min = tmin(my_min, t);
      }
    }
    const T b = block_min(my_min, red_t);
    const T thr = b * onetol;

    // freeze the bottleneck group and subtract its bandwidth
    for (int k = 0; k < iters; ++k) {
      const int f = g + k * per_block;
      bool newly = false;
      if (f < F) newly = frozen[f] < T(0.5) && tight[f] <= thr;
      __syncwarp();
      if (newly) {
        if (gl == 0) {
          rates[f] = b;
          frozen[f] = T(1);
        }
        for (int h = gl; h < H; h += G) atomicAdd(&s_used[fl[(long long)f * H + h]], b);
      }
    }
    __syncthreads();
    for (int l = threadIdx.x; l < Lc; l += blockDim.x) {
      s_cap[l] = tmax(s_cap[l] - s_used[l], T(0));
      s_used[l] = T(0);
      s_cnt[l] = 0;
    }
    __syncthreads();
  }

  for (int l = threadIdx.x; l < Lc; l += blockDim.x) cap_out[l] = s_cap[l];
  if (floor_rates)
    for (int f = threadIdx.x; f < F; f += blockDim.x) rates[f] = tmax(rates[f], T(1e-9));
}

// The same filling for lanes whose link range does not fit in shared
// memory: all CTAs of a cooperative launch work on one lane at a time,
// with grid-wide barriers between the phases.  cap_out is the working
// remaining-capacity vector; used / cnt are global scratch of Lc entries;
// scal holds two (live count, bottleneck bits) slots used in alternate
// rounds so that resetting one never races with reading the other.

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxmin_fill_grid(const int* __restrict__ fl, int B, int F, int H, const T* __restrict__ cap,
                 long long cap_stride, int Lc, T* __restrict__ rates, T* __restrict__ frozen,
                 T* __restrict__ cap_out, T* __restrict__ tight, T* __restrict__ used,
                 int* __restrict__ cnt, long long* __restrict__ scal, int bound, T onetol,
                 int floor_rates, int G) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T red_t[32];
  __shared__ int red_i[32];
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const int per_grid = (int)(nthreads / G);
  const int g = (int)(tid / G), gl = (int)(tid % G);
  const int iters = (F + per_grid - 1) / per_grid;
  const T inf = inf_of<T>();
  const long long inf_bits = ordered(inf);

  for (int lane = 0; lane < B; ++lane) {
    const int* lfl = fl + (long long)lane * F * H;
    const T* lcap = cap + lane * cap_stride;
    T* lrates = rates + (long long)lane * F;
    T* lfrozen = frozen + (long long)lane * F;
    T* ltight = tight + (long long)lane * F;
    T* lcr = cap_out + (long long)lane * Lc;

    for (long long l = tid; l < Lc; l += nthreads) {
      lcr[l] = lcap[l];
      used[l] = T(0);
      cnt[l] = 0;
    }
    if (tid == 0) {
      scal[0] = 0;
      scal[1] = inf_bits;
      scal[2] = 0;
      scal[3] = inf_bits;
    }
    grid.sync();

    for (int it = 0;; ++it) {
      long long* live_slot = scal + 2 * (it & 1);
      long long* b_slot = live_slot + 1;
      int my_live = 0;
      for (int k = 0; k < iters; ++k) {
        const int f = g + k * per_grid;
        if (f < F && lfrozen[f] < T(0.5)) {
          if (gl == 0) ++my_live;
          for (int h = gl; h < H; h += G) atomicAdd(&cnt[lfl[(long long)f * H + h]], 1);
        }
      }
      const int blk_live = block_sum(my_live, red_i);
      if (threadIdx.x == 0 && blk_live) atomicAdd((unsigned long long*)live_slot, (unsigned long long)blk_live);
      grid.sync();
      const long long live = *(volatile long long*)live_slot;
      if (live == 0 || it > bound) break;
      if (tid == 0) {               // the other slot serves the next round
        long long* nxt = scal + 2 * ((it + 1) & 1);
        nxt[0] = 0;
        nxt[1] = inf_bits;
      }

      T my_min = inf;
      for (int k = 0; k < iters; ++k) {
        const int f = g + k * per_grid;
        T t = inf;
        if (f < F) {
          for (int h = gl; h < H; h += G) {
            const int l = lfl[(long long)f * H + h];
            const int c = cnt[l];
            t = tmin(t, c > 0 ? lcr[l] / T(c) : inf);
          }
        }
        t = group_min(t, G);
        if (f < F && gl == 0) {
          ltight[f] = t;
          if (lfrozen[f] < T(0.5)) my_min = tmin(my_min, t);
        }
      }
      const T blk_min = block_min(my_min, red_t);
      if (threadIdx.x == 0 && blk_min < inf) atomicMin(b_slot, ordered(blk_min));
      grid.sync();
      const T b = from_ordered<T>(*(volatile long long*)b_slot);
      const T thr = b * onetol;

      for (int k = 0; k < iters; ++k) {
        const int f = g + k * per_grid;
        bool newly = false;
        if (f < F) newly = lfrozen[f] < T(0.5) && ltight[f] <= thr;
        __syncwarp();
        if (newly) {
          if (gl == 0) {
            lrates[f] = b;
            lfrozen[f] = T(1);
          }
          for (int h = gl; h < H; h += G) atomicAdd(&used[lfl[(long long)f * H + h]], b);
        }
      }
      grid.sync();
      for (long long l = tid; l < Lc; l += nthreads) {
        lcr[l] = tmax(lcr[l] - used[l], T(0));
        used[l] = T(0);
        cnt[l] = 0;
      }
      grid.sync();
    }
    if (floor_rates)
      for (long long f = tid; f < F; f += nthreads) lrates[f] = tmax(lrates[f], T(1e-9));
    grid.sync();
  }
}

// ----------------------------------------------------------- loss_factors
//
// Phase 1 scatters active * rate and the active count of every flow onto
// its links (global atomics over all lanes at once); phase 2 gives each
// flow its hot mark (any crossed link with >= 2 active flows at
// utilization >= cap * (1 - util_eps)) and evaluates the go-back-N x
// DCQCN factor exactly as loss_factors_reference writes it.

template <typename T>
__global__ void __launch_bounds__(kThreads)
loss_scatter(const int* __restrict__ fl, int B, int F, int H, const T* __restrict__ rates,
             const T* __restrict__ active, int Lc, T* __restrict__ util, int* __restrict__ cnt) {
  const long long n = (long long)B * F * H;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / H;           // lane * F + flow
    const T a = active[row];
    if (a != T(0)) {
      const long long base = (row / F) * Lc;
      const int l = fl[e];
      atomicAdd(&util[base + l], a * rates[row]);
      atomicAdd(&cnt[base + l], (int)a);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
loss_apply(const int* __restrict__ fl, int B, int F, int H, const T* __restrict__ rates,
           const T* __restrict__ cap, long long cap_stride, int Lc, const T* __restrict__ q,
           const T* __restrict__ wsq, const T* __restrict__ wnd, const T* __restrict__ ecn,
           const T* __restrict__ util, const int* __restrict__ cnt, T* __restrict__ fac,
           T dcqcn_num, T dcqcn_min, T one_minus_eps, int G) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_grid = (long long)gridDim.x * blockDim.x / G;
  const long long rows = (long long)B * F;
  const long long iters = (rows + per_grid - 1) / per_grid;
  const long long g = tid / G;
  const int gl = (int)(tid % G);
  for (long long k = 0; k < iters; ++k) {
    const long long row = g + k * per_grid;
    T hot = T(0);
    if (row < rows) {
      const long long lane = row / F;
      const T* lcap = cap + lane * cap_stride;
      const T* lutil = util + lane * Lc;
      const int* lcnt = cnt + lane * Lc;
      for (int h = gl; h < H; h += G) {
        const int l = fl[row * H + h];
        const bool is_hot = lcnt[l] >= 2 && lutil[l] >= lcap[l] * one_minus_eps;
        hot = tmax(hot, is_hot ? T(1) : T(0));
      }
    }
    hot = group_max(hot, G);
    if (row < rows && gl == 0) {
      const T r = rates[row], qq = q[row];
      const T w = tmin(tsqrt(tmax(r * wsq[row], T(0))), wnd[row]);
      const T gbn = (T(1) - qq) / tmax(T(1) - qq + qq * w, T(1e-30));
      const T rr = tmax(r, T(1e-30));
      const T alpha = tmin(tmax(dcqcn_num / rr, T(0)), T(1));
      const T dc = T(1) - T(0.25) * alpha * ecn[row] * hot;
      const T floor_ = tmin(dcqcn_min / rr, T(1));
      fac[row] = tmin(tmax(gbn * tmax(dc, floor_), T(1e-9)), T(1));
    }
  }
}

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 4096) blocks = 4096;
  return (int)blocks;
}

template <typename T>
int fill(const int* fl, int B, int F, int H, const T* cap, long long cap_stride, int Lc,
         T* rates, T* frozen, T* cap_out, T* tight, T* used, int* cnt, long long* scal,
         int bound, double tol, int floor_rates, int G, cudaStream_t stream) {
  cudaError_t err;
  if (B == 0 || F == 0) return (int)cudaGetLastError();
  const T onetol = T(1.0 + tol);
  int dev = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  const size_t smem = (size_t)Lc * (2 * sizeof(T) + sizeof(int));
  const size_t reserve = 2048;      // the kernel's static shared arrays
  if (smem + reserve <= (size_t)optin) {
    if ((err = cudaFuncSetAttribute(maxmin_fill_lane<T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    maxmin_fill_lane<T><<<B, kThreads, smem, stream>>>(fl, F, H, cap, cap_stride, Lc, rates,
                                                       frozen, cap_out, tight, bound, onetol,
                                                       floor_rates, G);
    return (int)cudaGetLastError();
  }
  int per_sm = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, maxmin_fill_grid<T>,
                                                           kThreads, 0)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  long long need = (long long)F * G > Lc ? (long long)F * G : (long long)Lc;
  long long blocks = (need + kThreads - 1) / kThreads;
  const long long resident = (long long)per_sm * sms;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  void* args[] = {(void*)&fl,    (void*)&B,      (void*)&F,      (void*)&H,
                  (void*)&cap,   (void*)&cap_stride, (void*)&Lc, (void*)&rates,
                  (void*)&frozen, (void*)&cap_out, (void*)&tight, (void*)&used,
                  (void*)&cnt,   (void*)&scal,   (void*)&bound,  (void*)&onetol,
                  (void*)&floor_rates, (void*)&G};
  if ((err = cudaLaunchCooperativeKernel((void*)maxmin_fill_grid<T>, dim3((unsigned)blocks),
                                         dim3(kThreads), args, 0, stream)) != cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int loss(const int* fl, int B, int F, int H, const T* rates, const T* active, const T* cap,
         long long cap_stride, int Lc, const T* q, const T* wsq, const T* wnd, const T* ecn,
         T* fac, T* util, int* cnt, double dcqcn_num, double dcqcn_min, double util_eps, int G,
         cudaStream_t stream) {
  cudaError_t err;
  if (B == 0 || F == 0) return (int)cudaGetLastError();
  if ((err = cudaMemsetAsync(util, 0, sizeof(T) * (size_t)B * Lc, stream)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)B * Lc, stream)) != cudaSuccess)
    return (int)err;
  loss_scatter<T><<<grid_for((long long)B * F * H), kThreads, 0, stream>>>(fl, B, F, H, rates,
                                                                          active, Lc, util, cnt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  loss_apply<T><<<grid_for((long long)B * F * G), kThreads, 0, stream>>>(
      fl, B, F, H, rates, cap, cap_stride, Lc, q, wsq, wnd, ecn, util, cnt, fac, T(dcqcn_num),
      T(dcqcn_min), T(1.0 - util_eps), G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int maxmin_fill_f32(const int* fl, int B, int F, int H, const float* cap, long long cap_stride,
                    int Lc, float* rates, float* frozen, float* cap_out, float* tight,
                    float* used, int* cnt, long long* scal, int bound, double tol,
                    int floor_rates, int G, void* stream) {
  return fill<float>(fl, B, F, H, cap, cap_stride, Lc, rates, frozen, cap_out, tight, used, cnt,
                     scal, bound, tol, floor_rates, G, (cudaStream_t)stream);
}

int maxmin_fill_f64(const int* fl, int B, int F, int H, const double* cap, long long cap_stride,
                    int Lc, double* rates, double* frozen, double* cap_out, double* tight,
                    double* used, int* cnt, long long* scal, int bound, double tol,
                    int floor_rates, int G, void* stream) {
  return fill<double>(fl, B, F, H, cap, cap_stride, Lc, rates, frozen, cap_out, tight, used, cnt,
                      scal, bound, tol, floor_rates, G, (cudaStream_t)stream);
}

int loss_factors_f32(const int* fl, int B, int F, int H, const float* rates, const float* active,
                     const float* cap, long long cap_stride, int Lc, const float* q,
                     const float* wsq, const float* wnd, const float* ecn, float* fac,
                     float* util, int* cnt, double dcqcn_num, double dcqcn_min, double util_eps,
                     int G, void* stream) {
  return loss<float>(fl, B, F, H, rates, active, cap, cap_stride, Lc, q, wsq, wnd, ecn, fac, util,
                     cnt, dcqcn_num, dcqcn_min, util_eps, G, (cudaStream_t)stream);
}

int loss_factors_f64(const int* fl, int B, int F, int H, const double* rates,
                     const double* active, const double* cap, long long cap_stride, int Lc,
                     const double* q, const double* wsq, const double* wnd, const double* ecn,
                     double* fac, double* util, int* cnt, double dcqcn_num, double dcqcn_min,
                     double util_eps, int G, void* stream) {
  return loss<double>(fl, B, F, H, rates, active, cap, cap_stride, Lc, q, wsq, wnd, ecn, fac,
                      util, cnt, dcqcn_num, dcqcn_min, util_eps, G, (cudaStream_t)stream);
}

const char* kernels_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
