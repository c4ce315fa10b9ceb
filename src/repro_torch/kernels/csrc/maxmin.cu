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
// times and do a handful of operations per id: by bytes and operations
// alike the card could finish a call in well under a microsecond (a
// fig14 lane of 32,768 flows x 8 hops is 1 MB of ids).  What costs is
// (a) the call itself: the host work of the wrapper and one launch,
// which set the time of every lane of a few hundred links; (b) latency:
// the phases of a round depend on each other (demand -> share ->
// bottleneck -> freeze -> subtract), so a round is a chain of barriers,
// CTA-wide in shared memory or grid-wide for lanes that do not fit; and
// (c) how many loads one SM keeps in flight when one CTA walks a lane of
// 100k+ link ids.  The design:
//
// (1) One launch a call, rounds included, and nothing else enqueued: the
//     kernel turns the caller's mask into (frozen, rates) itself, keeps
//     its state in shared memory or in a scratch buffer it resets, and
//     ends on a device-side "no live flow" test with no host sync per
//     round.  Device attributes, the shared-memory opt-in and the grid's
//     occupancy are looked up once per device.
// (2) No hop on the sentinel touches memory.  Its share is +inf whatever
//     its count, so it can never be a flow's tightest link; padded hops
//     (most of a multicast tree's row) used to pile atomics onto one
//     word.  Its cap_out entry is the input's (+inf), or NaN below.
// (3) Demand counts are kept across rounds: counted once, then each newly
//     frozen flow subtracts itself from its links while it adds b to
//     their frozen bandwidth; each link's share cap/cnt is worked out
//     once a round, per link, not once per hop.  A round is a tight pass
//     (gather-min of shares over the live flows' hops), a freeze pass
//     over the bottleneck group's hops and a per-link pass: three
//     barriers.
// (4) maxmin_fill_lane: one CTA per lane when its links fit shared memory
//     (cap, used, share, count: Lc * (3 * sizeof(T) + 4) bytes), up to
//     1024 threads; a row is walked by a group of G threads (a power of
//     two, 16-byte loads of 4 ids where H allows), and G grows past a
//     warp when a lane has few long rows, so that the CTA keeps loads in
//     flight.  It serves many short lanes (the matrix's 80 segments, the
//     packet gates' lanes of a few links).
// (5) maxmin_fill_grid: lanes too large for shared memory (a 16k-host fat
//     tree's 50k links), and a few long lanes (B <= 4 of 32k+ ids:
//     fig15's trees, where one SM and a link every flow crosses cost
//     0.15-0.20 ms of shared-memory atomics against 0.03 here) run on
//     every SM with a cooperative launch; the state lives in global
//     scratch (L2-resident, its atomics taken there), and each phase
//     walks ALL lanes before one grid-wide barrier, with a live count and
//     a bottleneck slot per lane (double-buffered by round parity): a
//     round costs three grid barriers whatever B is.
// (6) loss_factors: one kernel a call, no memset.  One CTA per lane scatters
//     utilization and active counts into shared memory, then marks hot
//     links and evaluates the factor; lanes whose links do not fit run
//     on the grid with scratch (reset, scatter, apply: two barriers).
//
// Exactness.  Demand is counted with int32 atomics, so the freeze set is
// exact.  The frozen bandwidth subtracted from a link is the bottleneck b
// added once per newly frozen flow crossing it; the addends are all equal,
// so the atomic order cannot change the sum, and the result is
// bit-identical to the plain version's index_add_ (no per-warp or per-CTA
// combining of those adds: that would round differently).  At a round
// whose bottleneck is +inf (a live flow over +inf links only, or a lane
// with no live flow in maxmin_round) the plain version adds 0 * inf = NaN
// (and inf - inf) onto every link any row of the lane crosses; the kernel
// writes NaN there too.  The loss kernel's per-link utilization sums
// different rates with atomics, so its last bit may differ from run to
// run (held to 1e-6); the build passes -fmad=false so every other
// expression rounds as the plain version's separate PyTorch ops do.
//
// Every entry point returns cudaGetLastError() (or the first error of a
// runtime call) as an int; the Python wrapper raises when it is non-zero.
// maxmin_kernels_launched() counts the kernels the library has launched.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kLaneThreads = 1024;  // most threads of a lane kernel's CTA
constexpr int kGridThreads = 512;   // threads of a grid kernel's CTA
constexpr int kMaxDevices = 64;
constexpr size_t kAlign = 256;      // scratch regions start on this

std::atomic<long long> g_kernels{0};  // kernels launched

template <typename T> __device__ __forceinline__ T inf_of();
template <> __device__ __forceinline__ float inf_of<float>() { return __int_as_float(0x7f800000); }
template <> __device__ __forceinline__ double inf_of<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}
template <typename T> __device__ __forceinline__ T nan_of();
template <> __device__ __forceinline__ float nan_of<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double nan_of<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// tmax(x, 0) keeps a NaN x, as torch.clamp does.
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

struct MinOp {
  template <typename T> __device__ T operator()(T a, T b) const { return tmin(a, b); }
};
struct MaxOp {
  template <typename T> __device__ T operator()(T a, T b) const { return tmax(a, b); }
};
struct SumOp {
  template <typename T> __device__ T operator()(T a, T b) const { return a + b; }
};

// Reduction over the G threads of a group (G a power of two, groups
// aligned in the CTA); every thread of the group gets the result.  Past a
// warp it goes through `red` (one entry a warp) with two barriers, so
// every thread of the CTA must call it equally often.
template <typename T, typename Op> __device__ T group_reduce(T v, int G, T* red, Op op) {
  const int w = G < 32 ? G : 32;
  for (int o = w >> 1; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (G <= 32) return v;
  const int warp = threadIdx.x >> 5, per = G >> 5, first = warp & ~(per - 1);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  T r = red[first];
  for (int i = 1; i < per; ++i) r = op(r, red[first + i]);
  return r;
}

// CTA-wide reduction, every thread gets the result; one barrier, so two
// calls on the same `red` need a barrier between them (`fenced` adds one
// in front, for calls in a loop).
template <typename T, typename Op> __device__ T block_reduce(T v, T* red, Op op, bool fenced) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  if (fenced) __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < nwarps; ++w) r = op(r, red[w]);
  return r;
}

// Calls fn(id) for the link ids of one row that thread gl of a group of
// G walks: 16-byte loads of four ids when VEC is 4 (H a multiple of 4,
// rows 16-byte aligned), else one id a load.
template <int VEC, typename Fn>
__device__ __forceinline__ void each_hop(const int* row, int H, int gl, int G, Fn fn) {
  if constexpr (VEC == 4) {
    const int4* p = reinterpret_cast<const int4*>(row);
    const int n = H >> 2;
#pragma unroll 4
    for (int c = gl; c < n; c += G) {
      const int4 v = __ldg(p + c);
      fn(v.x);
      fn(v.y);
      fn(v.z);
      fn(v.w);
    }
  } else {
#pragma unroll 4
    for (int h = gl; h < H; h += G) fn(__ldg(row + h));
  }
}

// ------------------------------------------------------------ maxmin_fill
//
// One round, as maxmin_round_reference computes it:
//   cnt[l]   = number of live (unfrozen) flows crossing l
//   share[l] = cnt > 0 ? cap_rem[l] / cnt : inf
//   tight[f] = min over f's links of share;  b = min over live f of tight
//   newly    = live & tight <= b * (1 + tol): rate b, frozen
//   cap_rem  = max(cap_rem - (b per newly frozen flow on the link), 0)
// repeated while some flow is live and the round index is <= bound
// (maxmin_round: exactly one round, whatever is live).

template <typename T> struct FillArgs {
  const int* fl;
  int B, F, H;
  const T* cap;
  long long cap_stride;
  int Lc;
  const void* state;  // kind 0: active (T); 1: active (bool); 2: frozen (T)
  int state_kind;
  const T* rates_in;  // kind 2: the rates the round starts from
  T* rates;           // (B, F) out
  T* frozen;          // (B, F) out
  T* cap_out;         // (B, Lc) out
  T* tight;           // (B, F) scratch
  T* used;            // (B, Lc) scratch (grid)
  T* share;           // (B, Lc) scratch (grid)
  int* cnt;           // (B, Lc) scratch (grid)
  long long* live;    // (B,) live flows of each lane (grid)
  long long* fresh;   // (B,) flows frozen this round (grid)
  long long* bslot;   // (2, B) bottleneck bits by round parity (grid)
  long long* total;   // live flows of every lane (grid)
  int bound;
  T onetol;
  int one_round;
  int floor_rates;
  int G;
};

template <typename T> __device__ __forceinline__ void init_flow(const FillArgs<T>& a, long long i) {
  if (a.state_kind == 2) {
    a.frozen[i] = static_cast<const T*>(a.state)[i];
    a.rates[i] = a.rates_in[i];
  } else {
    const T act = a.state_kind == 1 ? (static_cast<const bool*>(a.state)[i] ? T(1) : T(0))
                                    : static_cast<const T*>(a.state)[i];
    a.frozen[i] = T(1) - act;
    a.rates[i] = T(0);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kLaneThreads) maxmin_fill_lane(FillArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = a.F, H = a.H, Lc = a.Lc, sent = Lc - 1, G = a.G;
  T* s_cap = reinterpret_cast<T*>(smem);
  T* s_used = s_cap + Lc;
  T* s_share = s_used + Lc;
  int* s_cnt = reinterpret_cast<int*>(s_share + Lc);
  __shared__ T red_t[32], red_g[32];
  __shared__ int red_i[32];

  const long long lane = blockIdx.x;
  const int* fl = a.fl + lane * F * H;
  const T* cap = a.cap + lane * a.cap_stride;
  T* rates = a.rates + lane * F;
  T* frozen = a.frozen + lane * F;
  T* tight = a.tight + lane * F;
  T* cap_out = a.cap_out + lane * Lc;
  const T inf = inf_of<T>();

  for (int f = threadIdx.x; f < F; f += blockDim.x) init_flow(a, lane * F + f);
  for (int l = threadIdx.x; l < Lc; l += blockDim.x) {
    s_cap[l] = __ldg(cap + l);
    s_used[l] = T(0);
    s_cnt[l] = 0;
  }
  __syncthreads();

  const int per = blockDim.x / G, g = threadIdx.x / G, gl = threadIdx.x % G;
  const int iters = (F + per - 1) / per;

  // demand of the live flows, once
  int mine = 0;
  for (int k = 0; k < iters; ++k) {
    const int f = g + k * per;
    if (f < F && frozen[f] < T(0.5)) {
      if (gl == 0) ++mine;
      each_hop<VEC>(fl + (long long)f * H, H, gl, G, [&](int l) {
        if (l != sent) atomicAdd(&s_cnt[l], 1);
      });
    }
  }
  int live = block_reduce(mine, red_i, SumOp{}, false);
  for (int l = threadIdx.x; l < Lc; l += blockDim.x) {
    const int c = s_cnt[l];
    s_share[l] = c > 0 ? s_cap[l] / T(c) : inf;
  }
  __syncthreads();

  for (int it = 0; it <= a.bound && (live > 0 || (a.one_round && it == 0)); ++it) {
    // tightest share per live flow and the bottleneck b
    T my_min = inf;
    for (int k = 0; k < iters; ++k) {
      const int f = g + k * per;
      const bool lv = f < F && frozen[f] < T(0.5);
      T t = inf;
      if (lv)
        each_hop<VEC>(fl + (long long)f * H, H, gl, G, [&](int l) {
          if (l != sent) t = tmin(t, s_share[l]);
        });
      t = group_reduce(t, G, red_g, MinOp{});
      if (lv && gl == 0) {
        tight[f] = t;
        my_min = tmin(my_min, t);
      }
    }
    const T b = block_reduce(my_min, red_t, MinOp{}, false);
    const T thr = b * a.onetol;

    // the bottleneck group's bandwidth onto its links, its flows off the
    // demand; at b = +inf every link a row crosses turns NaN
    for (int k = 0; k < iters; ++k) {
      const int f = g + k * per;
      if (f < F && frozen[f] < T(0.5) && tight[f] <= thr)
        each_hop<VEC>(fl + (long long)f * H, H, gl, G, [&](int l) {
          if (l != sent) {
            atomicAdd(&s_used[l], b);
            atomicSub(&s_cnt[l], 1);
          }
        });
    }
    if (!(b < inf))
      for (int k = 0; k < iters; ++k) {
        const int f = g + k * per;
        if (f < F)
          each_hop<VEC>(fl + (long long)f * H, H, gl, G,
                        [&](int l) { s_cap[l] = nan_of<T>(); });
      }
    __syncthreads();

    // subtract, next shares; freeze the group
    for (int l = threadIdx.x; l < Lc; l += blockDim.x) {
      const T c = tmax(s_cap[l] - s_used[l], T(0));
      const int n = s_cnt[l];
      s_cap[l] = c;
      s_used[l] = T(0);
      s_share[l] = n > 0 ? c / T(n) : inf;
    }
    int fresh = 0;
    for (int f = threadIdx.x; f < F; f += blockDim.x)
      if (frozen[f] < T(0.5) && tight[f] <= thr) {
        rates[f] = b;
        frozen[f] = T(1);
        ++fresh;
      }
    live -= block_reduce(fresh, red_i, SumOp{}, false);
  }

  for (int l = threadIdx.x; l < Lc; l += blockDim.x) cap_out[l] = s_cap[l];
  if (a.floor_rates)
    for (int f = threadIdx.x; f < F; f += blockDim.x) rates[f] = tmax(rates[f], T(1e-9));
}

// The same filling for lanes whose links do not fit shared memory: every
// CTA of a cooperative launch works on every lane, phase by phase, with
// one grid-wide barrier between phases.  cap_out is the working
// remaining capacity; used / share / cnt / tight and the per-lane slots
// are scratch, reset at the start.

template <typename T, int VEC>
__global__ void __launch_bounds__(kGridThreads) maxmin_fill_grid(FillArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T red_t[32], red_g[32];
  __shared__ int red_i[32];
  const int B = a.B, F = a.F, H = a.H, Lc = a.Lc, sent = Lc - 1, G = a.G;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long links = (long long)B * Lc, flows = (long long)B * F;
  const int per = (int)(nthreads / G), g = (int)(tid / G), gl = (int)(tid % G);
  const int iters = (F + per - 1) / per;
  const T inf = inf_of<T>();
  const long long inf_bits = ordered(inf);

  for (long long i = tid; i < flows; i += nthreads) init_flow(a, i);
  for (long long i = tid; i < links; i += nthreads) {
    a.cap_out[i] = __ldg(a.cap + (i / Lc) * a.cap_stride + i % Lc);
    a.used[i] = T(0);
    a.cnt[i] = 0;
  }
  if (tid < B) {
    a.live[tid] = 0;
    a.fresh[tid] = 0;
    a.bslot[tid] = inf_bits;
    a.bslot[B + tid] = inf_bits;
  }
  if (tid == 0) *a.total = 0;
  grid.sync();

  for (int lane = 0; lane < B; ++lane) {
    const int* fl = a.fl + (long long)lane * F * H;
    const T* frozen = a.frozen + (long long)lane * F;
    int* cnt = a.cnt + (long long)lane * Lc;
    int mine = 0;
    for (int k = 0; k < iters; ++k) {
      const int f = g + k * per;
      if (f < F && frozen[f] < T(0.5)) {
        if (gl == 0) ++mine;
        each_hop<VEC>(fl + (long long)f * H, H, gl, G, [&](int l) {
          if (l != sent) atomicAdd(&cnt[l], 1);
        });
      }
    }
    const int n = block_reduce(mine, red_i, SumOp{}, true);
    if (threadIdx.x == 0 && n) {
      atomicAdd(reinterpret_cast<unsigned long long*>(&a.live[lane]), (unsigned long long)n);
      atomicAdd(reinterpret_cast<unsigned long long*>(a.total), (unsigned long long)n);
    }
  }
  grid.sync();
  for (long long i = tid; i < links; i += nthreads) {
    const int c = a.cnt[i];
    a.share[i] = c > 0 ? a.cap_out[i] / T(c) : inf;
  }
  grid.sync();

  for (int it = 0; it <= a.bound; ++it) {
    const bool forced = a.one_round && it == 0;
    if (*(volatile long long*)a.total == 0 && !forced) break;
    long long* bnow = a.bslot + (it & 1) * B;

    // tightest shares; each lane's bottleneck
    for (int lane = 0; lane < B; ++lane) {
      if (!forced && *(volatile long long*)&a.live[lane] == 0) continue;
      const int* fl = a.fl + (long long)lane * F * H;
      const T* frozen = a.frozen + (long long)lane * F;
      const T* share = a.share + (long long)lane * Lc;
      T* tight = a.tight + (long long)lane * F;
      T my_min = inf;
      for (int k = 0; k < iters; ++k) {
        const int f = g + k * per;
        const bool lv = f < F && frozen[f] < T(0.5);
        T t = inf;
        if (lv)
          each_hop<VEC>(fl + (long long)f * H, H, gl, G, [&](int l) {
            if (l != sent) t = tmin(t, share[l]);
          });
        t = group_reduce(t, G, red_g, MinOp{});
        if (lv && gl == 0) {
          tight[f] = t;
          my_min = tmin(my_min, t);
        }
      }
      const T m = block_reduce(my_min, red_t, MinOp{}, true);
      if (threadIdx.x == 0 && m < inf) atomicMin(&bnow[lane], ordered(m));
    }
    grid.sync();

    // each lane's bottleneck group onto its links and off the demand
    for (int lane = 0; lane < B; ++lane) {
      if (!forced && *(volatile long long*)&a.live[lane] == 0) continue;
      const int* fl = a.fl + (long long)lane * F * H;
      const T* frozen = a.frozen + (long long)lane * F;
      const T* tight = a.tight + (long long)lane * F;
      T* used = a.used + (long long)lane * Lc;
      T* cap_rem = a.cap_out + (long long)lane * Lc;
      int* cnt = a.cnt + (long long)lane * Lc;
      const T b = from_ordered<T>(*(volatile long long*)&bnow[lane]);
      const T thr = b * a.onetol;
      int mine = 0;
      for (int k = 0; k < iters; ++k) {
        const int f = g + k * per;
        if (f < F && frozen[f] < T(0.5) && tight[f] <= thr) {
          if (gl == 0) ++mine;
          each_hop<VEC>(fl + (long long)f * H, H, gl, G, [&](int l) {
            if (l != sent) {
              atomicAdd(&used[l], b);
              atomicSub(&cnt[l], 1);
            }
          });
        }
      }
      if (!(b < inf))
        for (int k = 0; k < iters; ++k) {
          const int f = g + k * per;
          if (f < F)
            each_hop<VEC>(fl + (long long)f * H, H, gl, G,
                          [&](int l) { cap_rem[l] = nan_of<T>(); });
        }
      const int n = block_reduce(mine, red_i, SumOp{}, true);
      if (threadIdx.x == 0 && n)
        atomicAdd(reinterpret_cast<unsigned long long*>(&a.fresh[lane]), (unsigned long long)n);
    }
    grid.sync();

    // subtract, next shares, freeze the groups; the lane counts
    for (long long i = tid; i < links; i += nthreads) {
      const T c = tmax(a.cap_out[i] - a.used[i], T(0));
      const int n = a.cnt[i];
      a.cap_out[i] = c;
      a.used[i] = T(0);
      a.share[i] = n > 0 ? c / T(n) : inf;
    }
    for (long long i = tid; i < flows; i += nthreads) {
      const T b = from_ordered<T>(*(volatile long long*)&bnow[i / F]);
      if (a.frozen[i] < T(0.5) && a.tight[i] <= b * a.onetol) {
        a.rates[i] = b;
        a.frozen[i] = T(1);
      }
    }
    if (tid < B) {
      const long long n = a.fresh[tid];
      a.live[tid] -= n;
      a.fresh[tid] = 0;
      a.bslot[((it + 1) & 1) * B + tid] = inf_bits;
      if (n) atomicAdd(reinterpret_cast<unsigned long long*>(a.total), (unsigned long long)(-n));
    }
    grid.sync();
  }
  if (a.floor_rates)
    for (long long i = tid; i < flows; i += nthreads) a.rates[i] = tmax(a.rates[i], T(1e-9));
}

// ----------------------------------------------------------- loss_factors
//
// Scatters active * rate and the active count of every flow onto its
// links, then gives each flow its hot mark (any crossed link with >= 2
// active flows at utilization >= cap * (1 - util_eps)) and evaluates the
// go-back-N x DCQCN factor exactly as loss_factors_reference writes it.

template <typename T> struct LossArgs {
  const int* fl;
  int B, F, H;
  const T* rates;
  const T* active;
  const T* cap;
  long long cap_stride;
  int Lc;
  const T *q, *wsq, *wnd, *ecn;
  T* fac;
  T* util;   // (B, Lc) scratch (grid)
  int* cnt;  // (B, Lc) scratch (grid)
  T dcqcn_num, dcqcn_min, one_minus_eps;
  int G;
};

template <typename T>
__device__ __forceinline__ T loss_factor(const LossArgs<T>& a, long long row, T hot) {
  const T r = a.rates[row], qq = a.q[row];
  const T w = tmin(tsqrt(tmax(r * a.wsq[row], T(0))), a.wnd[row]);
  const T gbn = (T(1) - qq) / tmax(T(1) - qq + qq * w, T(1e-30));
  const T rr = tmax(r, T(1e-30));
  const T alpha = tmin(tmax(a.dcqcn_num / rr, T(0)), T(1));
  const T dc = T(1) - T(0.25) * alpha * a.ecn[row] * hot;
  const T floor_ = tmin(a.dcqcn_min / rr, T(1));
  return tmin(tmax(gbn * tmax(dc, floor_), T(1e-9)), T(1));
}

// One lane's flows, rows g, g + per, ...: the scatter (phase 0) or the
// factors (phase 1), util / cnt the lane's vectors (shared or global).
template <typename T, int VEC>
__device__ __forceinline__ void loss_rows(const LossArgs<T>& a, int phase, long long lane,
                                          T* util, int* cnt, int g, int gl, int per, T* red) {
  const int F = a.F, H = a.H, sent = a.Lc - 1, G = a.G;
  const int* fl = a.fl + lane * F * H;
  const T* cap = a.cap + lane * a.cap_stride;
  const T ome = a.one_minus_eps;
  const int iters = (F + per - 1) / per;
  for (int k = 0; k < iters; ++k) {
    const int f = g + k * per;
    const long long row = lane * F + f;
    if (phase == 0) {
      if (f < F) {
        const T act = a.active[row];
        if (act != T(0)) {
          const T u = act * a.rates[row];
          const int c = (int)act;
          each_hop<VEC>(fl + (long long)f * H, H, gl, G, [&](int l) {
            if (l != sent) {
              atomicAdd(&util[l], u);
              atomicAdd(&cnt[l], c);
            }
          });
        }
      }
    } else {
      T hot = T(0);
      if (f < F)
        each_hop<VEC>(fl + (long long)f * H, H, gl, G, [&](int l) {
          if (l != sent && cnt[l] >= 2 && util[l] >= __ldg(cap + l) * ome) hot = T(1);
        });
      hot = group_reduce(hot, G, red, MaxOp{});
      if (f < F && gl == 0) a.fac[row] = loss_factor(a, row, hot);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kLaneThreads) loss_lane(LossArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_util = reinterpret_cast<T*>(smem);
  int* s_cnt = reinterpret_cast<int*>(s_util + a.Lc);
  __shared__ T red[32];
  for (int l = threadIdx.x; l < a.Lc; l += blockDim.x) {
    s_util[l] = T(0);
    s_cnt[l] = 0;
  }
  __syncthreads();
  const int per = blockDim.x / a.G, g = threadIdx.x / a.G, gl = threadIdx.x % a.G;
  loss_rows<T, VEC>(a, 0, blockIdx.x, s_util, s_cnt, g, gl, per, red);
  __syncthreads();
  loss_rows<T, VEC>(a, 1, blockIdx.x, s_util, s_cnt, g, gl, per, red);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kGridThreads) loss_grid(LossArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T red[32];
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long links = (long long)a.B * a.Lc;
  for (long long i = tid; i < links; i += nthreads) {
    a.util[i] = T(0);
    a.cnt[i] = 0;
  }
  grid.sync();
  const int per = (int)(nthreads / a.G), g = (int)(tid / a.G), gl = (int)(tid % a.G);
  for (int phase = 0; phase < 2; ++phase) {
    for (long long lane = 0; lane < a.B; ++lane)
      loss_rows<T, VEC>(a, phase, lane, a.util + lane * a.Lc, a.cnt + lane * a.Lc, g, gl, per,
                        red);
    if (phase == 0) grid.sync();
  }
}

// ------------------------------------------------------------------- host

// What a device offers, looked up once: the dynamic shared memory a lane
// kernel may take (each lane kernel's attribute set to it) and the CTAs
// of a grid kernel that fit at once.
struct Device {
  std::once_flag once;
  cudaError_t err = cudaSuccess;
  int smem = 0;
  int sms = 0;
  long long resident[2][2][2] = {};  // [fill, loss][f32, f64][VEC 1, 4]
};
Device g_devices[kMaxDevices];

template <typename T, int VEC> cudaError_t set_up(Device& d) {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(maxmin_fill_lane<T, VEC>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem)) ||
      (err = cudaFuncSetAttribute(loss_lane<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  d.smem)))
    return err;
  const int t = sizeof(T) == 8, v = VEC == 4;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, maxmin_fill_grid<T, VEC>,
                                                           kGridThreads, 0)))
    return err;
  d.resident[0][t][v] = (long long)per_sm * d.sms;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, loss_grid<T, VEC>,
                                                           kGridThreads, 0)))
    return err;
  d.resident[1][t][v] = (long long)per_sm * d.sms;
  return cudaSuccess;
}

Device* device_info(int dev, cudaError_t* err) {
  if (dev < 0 || dev >= kMaxDevices) {
    *err = cudaErrorInvalidDevice;
    return nullptr;
  }
  Device& d = g_devices[dev];
  std::call_once(d.once, [&d, dev] {
    int optin = 0;
    if ((d.err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (d.err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev)))
      return;
    d.smem = optin - 1024;  // room for the kernels' static arrays
    if ((d.err = set_up<float, 1>(d)) || (d.err = set_up<float, 4>(d)) ||
        (d.err = set_up<double, 1>(d)) || (d.err = set_up<double, 4>(d)))
      return;
  });
  *err = d.err;
  return d.err ? nullptr : &d;
}

// The caller's device made current for the length of a call.
struct OnDevice {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit OnDevice(int dev) {
    if ((err = cudaGetDevice(&prev)) != cudaSuccess || prev == dev)
      prev = -1;
    else
      err = cudaSetDevice(dev);
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// Scratch regions, each kAlign-aligned, in the order the wrapper sizes
// them (kernels/maxmin.py: _fill_bytes, _loss_bytes).
struct Carve {
  char* p;
  size_t left;
  bool ok = true;
  template <typename X> X* take(size_t n) {
    const size_t bytes = (n * sizeof(X) + kAlign - 1) / kAlign * kAlign;
    if (bytes > left) {
      ok = false;
      return nullptr;
    }
    X* out = reinterpret_cast<X*>(p);
    p += bytes;
    left -= bytes;
    return out;
  }
};

long long pow2_at_least(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

long long pow2_at_most(long long n) {
  long long p = 1;
  while (2 * p <= n) p <<= 1;
  return p;
}

// Threads of a lane kernel's CTA (at most `most`; a grid kernel passes the
// threads of its whole grid) and of a row's group G (at most `group_most`):
// a group is as many threads as a row has loads, up to a warp, and grows
// past the warp while the lane has fewer rows than the threads could take.
void shape(int F, int H, int vec, long long most, long long group_most, int* threads, int* G) {
  const long long chunks = pow2_at_least(vec == 4 ? H / 4 : H);
  const long long rows = pow2_at_least(F);
  const long long want = rows * chunks;
  const long long t = want < 64 ? 64 : (want > most ? most : want);
  long long g = chunks < 32 ? chunks : 32;
  const long long spread = pow2_at_most(t / rows > 0 ? t / rows : 1);
  if (spread > g) g = spread < chunks ? spread : chunks;
  *threads = (int)(t < kLaneThreads ? t : kLaneThreads);
  *G = (int)(g < group_most ? g : group_most);
}

bool lane_fits(const Device& d, int Lc, size_t per_link) {
  return (size_t)Lc * per_link <= (size_t)d.smem;
}

// The lane kernel, unless a lane's state does not fit shared memory or a
// few lanes carry many ids each: one SM then walks 32k+ ids and a link
// that every flow crosses (a multiunicast's source) serializes its
// shared-memory atomics, where the grid spreads the ids over every SM
// and the L2 takes the atomics (fig15's lanes on an H100: 0.15-0.20 ms of
// device time on one SM, 0.03 on the grid; 80 short lanes: 0.006 on the
// lane kernel, 0.33 on the grid).  `variant` 1 or 2 names one.
constexpr int kFewLanes = 4;
constexpr long long kLongLane = 32768;

bool use_lane(const Device& d, int variant, int B, int F, int H, int Lc, size_t per_link) {
  if (variant != 0) return variant == 1;
  return lane_fits(d, Lc, per_link) && !(B <= kFewLanes && (long long)F * H >= kLongLane);
}

int vec_of(const int* fl, int H) {
  return H % 4 == 0 && (reinterpret_cast<uintptr_t>(fl) & 15) == 0 ? 4 : 1;
}

// CTAs of a grid kernel: enough for the rows of one lane and for every
// link of every lane, at most what fits on the card at once.
long long grid_blocks(long long resident, int F, int G, int B, int Lc) {
  const long long rows = (long long)F * G, links = (long long)B * Lc;
  long long blocks = ((rows > links ? rows : links) + kGridThreads - 1) / kGridThreads;
  if (blocks > resident) blocks = resident;
  return blocks < 1 ? 1 : blocks;
}

template <typename T>
int fill(const int* fl, int B, int F, int H, const T* cap, long long cap_stride, int Lc,
         const void* state, int state_kind, const T* rates_in, T* rates, T* frozen, T* cap_out,
         void* scratch, long long scratch_bytes, int bound, double tol, int one_round,
         int floor_rates, int variant, int dev, cudaStream_t stream) {
  OnDevice on(dev);
  if (on.err) return (int)on.err;
  cudaError_t err;
  Device* d = device_info(dev, &err);
  if (!d) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  FillArgs<T> a{};
  a.fl = fl;
  a.B = B;
  a.F = F;
  a.H = H;
  a.cap = cap;
  a.cap_stride = cap_stride;
  a.Lc = Lc;
  a.state = state;
  a.state_kind = state_kind;
  a.rates_in = rates_in;
  a.rates = rates;
  a.bound = bound;
  a.onetol = T(1.0 + tol);
  a.one_round = one_round;
  a.floor_rates = floor_rates;
  Carve c{static_cast<char*>(scratch), (size_t)scratch_bytes};
  a.frozen = c.take<T>((size_t)B * F);
  a.cap_out = c.take<T>((size_t)B * Lc);
  if (frozen) a.frozen = frozen;
  if (cap_out) a.cap_out = cap_out;
  a.tight = c.take<T>((size_t)B * F);
  const size_t per_link = 3 * sizeof(T) + sizeof(int);
  if (variant == 1 && !lane_fits(*d, Lc, per_link)) return (int)cudaErrorInvalidValue;
  const int vec = vec_of(fl, H);
  if (use_lane(*d, variant, B, F, H, Lc, per_link)) {
    if (!c.ok) return (int)cudaErrorInvalidValue;
    int threads;
    shape(F, H, vec, kLaneThreads, kLaneThreads, &threads, &a.G);
    const size_t smem = (size_t)Lc * per_link;
    if (vec == 4)
      maxmin_fill_lane<T, 4><<<B, threads, smem, stream>>>(a);
    else
      maxmin_fill_lane<T, 1><<<B, threads, smem, stream>>>(a);
  } else {
    a.used = c.take<T>((size_t)B * Lc);
    a.share = c.take<T>((size_t)B * Lc);
    a.cnt = c.take<int>((size_t)B * Lc);
    long long* slots = c.take<long long>(4 * (size_t)B + 1);
    if (!c.ok) return (int)cudaErrorInvalidValue;
    a.live = slots;
    a.fresh = slots + B;
    a.bslot = slots + 2 * B;
    a.total = slots + 4 * B;
    const long long resident = d->resident[0][sizeof(T) == 8][vec == 4];
    int threads;
    shape(F, H, vec, resident * kGridThreads, kGridThreads, &threads, &a.G);
    void* args[] = {(void*)&a};
    const void* fn = vec == 4 ? (const void*)maxmin_fill_grid<T, 4>
                              : (const void*)maxmin_fill_grid<T, 1>;
    if ((err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid_blocks(resident, F, a.G, B, Lc)),
                                           dim3(kGridThreads), args, 0, stream)))
      return (int)err;
  }
  if ((err = cudaGetLastError())) return (int)err;
  ++g_kernels;
  return 0;
}

template <typename T>
int loss(const int* fl, int B, int F, int H, const T* rates, const T* active, const T* cap,
         long long cap_stride, int Lc, const T* q, const T* wsq, const T* wnd, const T* ecn, T* fac,
         void* scratch, long long scratch_bytes, double dcqcn_num, double dcqcn_min,
         double util_eps, int variant, int dev, cudaStream_t stream) {
  OnDevice on(dev);
  if (on.err) return (int)on.err;
  cudaError_t err;
  Device* d = device_info(dev, &err);
  if (!d) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  LossArgs<T> a{fl,  B,   F,   H,   rates,  active,  cap,     cap_stride,    Lc,
                q,   wsq, wnd, ecn, fac,    nullptr, nullptr, T(dcqcn_num),  T(dcqcn_min),
                T(1.0 - util_eps), 0};
  const size_t per_link = sizeof(T) + sizeof(int);
  if (variant == 1 && !lane_fits(*d, Lc, per_link)) return (int)cudaErrorInvalidValue;
  const int vec = vec_of(fl, H);
  if (use_lane(*d, variant, B, F, H, Lc, per_link)) {
    int threads;
    shape(F, H, vec, kLaneThreads, kLaneThreads, &threads, &a.G);
    const size_t smem = (size_t)Lc * per_link;
    if (vec == 4)
      loss_lane<T, 4><<<B, threads, smem, stream>>>(a);
    else
      loss_lane<T, 1><<<B, threads, smem, stream>>>(a);
  } else {
    Carve c{static_cast<char*>(scratch), (size_t)scratch_bytes};
    a.util = c.take<T>((size_t)B * Lc);
    a.cnt = c.take<int>((size_t)B * Lc);
    if (!c.ok) return (int)cudaErrorInvalidValue;
    const long long resident = d->resident[1][sizeof(T) == 8][vec == 4];
    int threads;
    shape(F, H, vec, resident * kGridThreads, kGridThreads, &threads, &a.G);
    void* args[] = {(void*)&a};
    const void* fn = vec == 4 ? (const void*)loss_grid<T, 4> : (const void*)loss_grid<T, 1>;
    if ((err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid_blocks(resident, F, a.G, B, Lc)),
                                           dim3(kGridThreads), args, 0, stream)))
      return (int)err;
  }
  if ((err = cudaGetLastError())) return (int)err;
  ++g_kernels;
  return 0;
}

}  // namespace

extern "C" {

int maxmin_fill_f32(const int* fl, int B, int F, int H, const float* cap, long long cap_stride,
                    int Lc, const void* state, int state_kind, const float* rates_in,
                    float* rates, float* frozen, float* cap_out, void* scratch,
                    long long scratch_bytes, int bound, double tol, int one_round,
                    int floor_rates, int variant, int device, void* stream) {
  return fill<float>(fl, B, F, H, cap, cap_stride, Lc, state, state_kind, rates_in, rates, frozen,
                     cap_out, scratch, scratch_bytes, bound, tol, one_round, floor_rates, variant,
                     device, (cudaStream_t)stream);
}

int maxmin_fill_f64(const int* fl, int B, int F, int H, const double* cap, long long cap_stride,
                    int Lc, const void* state, int state_kind, const double* rates_in,
                    double* rates, double* frozen, double* cap_out, void* scratch,
                    long long scratch_bytes, int bound, double tol, int one_round,
                    int floor_rates, int variant, int device, void* stream) {
  return fill<double>(fl, B, F, H, cap, cap_stride, Lc, state, state_kind, rates_in, rates, frozen,
                      cap_out, scratch, scratch_bytes, bound, tol, one_round, floor_rates,
                      variant, device, (cudaStream_t)stream);
}

int loss_factors_f32(const int* fl, int B, int F, int H, const float* rates, const float* active,
                     const float* cap, long long cap_stride, int Lc, const float* q,
                     const float* wsq, const float* wnd, const float* ecn, float* fac,
                     void* scratch, long long scratch_bytes, double dcqcn_num, double dcqcn_min,
                     double util_eps, int variant, int device, void* stream) {
  return loss<float>(fl, B, F, H, rates, active, cap, cap_stride, Lc, q, wsq, wnd, ecn, fac,
                     scratch, scratch_bytes, dcqcn_num, dcqcn_min, util_eps, variant, device,
                     (cudaStream_t)stream);
}

int loss_factors_f64(const int* fl, int B, int F, int H, const double* rates,
                     const double* active, const double* cap, long long cap_stride, int Lc,
                     const double* q, const double* wsq, const double* wnd, const double* ecn,
                     double* fac, void* scratch, long long scratch_bytes, double dcqcn_num,
                     double dcqcn_min, double util_eps, int variant, int device, void* stream) {
  return loss<double>(fl, B, F, H, rates, active, cap, cap_stride, Lc, q, wsq, wnd, ecn, fac,
                      scratch, scratch_bytes, dcqcn_num, dcqcn_min, util_eps, variant, device,
                      (cudaStream_t)stream);
}

// The kernel a call takes on the device: 1, the lane kernel, or 2, the
// grid kernel, of maxmin_fill (kind 0) or loss_factors (kind 1), for B
// lanes of F x H ids over Lc links; 3 when the lane kernel could take it
// too, but the grid was chosen; negative, a CUDA error.
int maxmin_variant(int kind, int B, int F, int H, int Lc, int elem, int device) {
  OnDevice on(device);
  if (on.err) return -(int)on.err;
  cudaError_t err;
  Device* d = device_info(device, &err);
  if (!d) return -(int)err;
  const size_t per_link = (kind == 0 ? 3 * (size_t)elem : (size_t)elem) + sizeof(int);
  if (use_lane(*d, 0, B, F, H, Lc, per_link)) return 1;
  return lane_fits(*d, Lc, per_link) ? 3 : 2;
}

long long maxmin_kernels_launched() { return g_kernels.load(); }

const char* kernels_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
