// Hopper (sm_90a) kernels of the router accumulation: the single-chunk plan
// (up to 2^21 slots), the large-graph plan (BigAccelPlan, up to 2^28 slots)
// and the tile plan's coarse level on either.
//
// Built by pyflwdir_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. Every entry takes an
// element-type code (0 float32, 1 int32, 2 int64, 3 float64), device
// pointers and a cudaStream_t (PyTorch's current stream), launches the
// kernel instantiated for that type, and returns cudaGetLastError();
// nothing here allocates or synchronises.
//
// The JAX package expresses each static permutation as a 5-stage chain of
// 128-lane gathers because the TPU has no fast gather (ops/router.py). On
// Hopper a permutation is one int32 gather, so the plan composes every chain
// into a single index at load time and these kernels read it directly.
//
// The JAX package's 7-stage chain of ops/router_big.py (_fused_pass: five
// fused Pallas passes of lane gathers and 128 x 128 rotations) is the same
// function at up to 2^28 elements and takes the same kernel, H0, with the
// chain composed into one int32 index.
//
// All four kernels move a few bytes per element and do one or two adds on
// them: they are bound by device-memory bytes (3.35 TB/s on an H100 SXM),
// and at the Rhine-size plan (688,128 slots) by launch latency. Past the
// 50 MB L2 (tens of millions of slots) a scattered 4- or 8-byte read
// fetches a whole 32-byte sector from device memory.
//
// Sizes: element counts and loop indices are 64-bit; an index holds a
// position below 2^31 (int32), so every array a kernel indexes has fewer
// than 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

inline int grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;  // 16.7 M threads; grid-stride loops cover the rest
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

// read-only cached load; int64_t is `long` here, __ldg takes `long long`
template <typename T>
__device__ __forceinline__ T ldg(const T* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ int64_t ldg<int64_t>(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

template <typename T>
__device__ __forceinline__ T shfl_up(T v, int off) {
  return __shfl_up_sync(0xffffffffu, v, off);
}
template <>
__device__ __forceinline__ int64_t shfl_up<int64_t>(int64_t v, int off) {
  return static_cast<int64_t>(
      __shfl_up_sync(0xffffffffu, static_cast<long long>(v), off));
}

template <typename T>
struct Tag {
  using type = T;
};

// call f(Tag<T>{}) for the element type named by dt
template <class F>
int by_dtype(int dt, F&& f) {
  switch (dt) {
    case 0: return f(Tag<float>{});
    case 1: return f(Tag<int32_t>{});
    case 2: return f(Tag<int64_t>{});
    case 3: return f(Tag<double>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// H0 permute_gather: out[p] = src[p] >= 0 ? x[src[p]] : 0.
// Replaces ops/router.py::_ta (lane gather) and RouterPlan.apply (the
// L-S-G-S-L chain) of the JAX package, ops/router_big.py::_fused_pass as
// RouterPlanBig._chain_fused runs it (the 7-stage chain; in BigAccelPlan
// r_out, and downward r_win, r_dea, r_deb, r_aout), and on the tile plan's
// coarse level ops/tile_plan.py::_CoarseRouterSmall._route for r_out and,
// downward, for r_win, r_dea, r_deb and r_aout with the mask selects after
// them (a masked slot holds -1).
// Bound: 4 bytes of index + 2 * sizeof(T) per element, each read or written
// once; a scattered read past the 50 MB L2 fetches a 32-byte sector.
// Design: a block of 256 threads takes a chunk of 1,024 consecutive slots,
// thread t the slots t, t + 256, t + 512 and t + 768: four independent
// gathers in flight a thread, and every load of src, gather instruction and
// store of out covers 32 consecutive slots across a warp (coalesced, and a
// DFS-local src gathers from few sectors). One chunk a block, a block per
// chunk. Four consecutive slots a thread (a 16-byte src load, vector
// stores, a grid of the SMs' resident blocks) ran slower on the 1-D path's
// indices, most in float64: each gather instruction spreads a warp over 4x
// the sectors (PERF.md, section 6). No alignment is assumed: any src view
// and any n work alike.
// ---------------------------------------------------------------------------
constexpr int kGatherPer = 4;  // slots a thread
constexpr int kGatherChunk = kThreads * kGatherPer;

template <typename T>
__global__ void __launch_bounds__(kThreads)
permute_gather_kernel(const T* __restrict__ x, const int32_t* __restrict__ src,
                      T* __restrict__ out, int64_t n) {
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kGatherChunk + threadIdx.x;
  int32_t s[kGatherPer];
#pragma unroll
  for (int j = 0; j < kGatherPer; ++j) {
    const int64_t p = p0 + j * kThreads;
    s[j] = p < n ? __ldg(src + p) : -1;
  }
  T v[kGatherPer];
#pragma unroll
  for (int j = 0; j < kGatherPer; ++j) v[j] = s[j] >= 0 ? ldg(x + s[j]) : T(0);
#pragma unroll
  for (int j = 0; j < kGatherPer; ++j) {
    const int64_t p = p0 + j * kThreads;
    if (p < n) out[p] = v[j];
  }
}

// ---------------------------------------------------------------------------
// H1 accel_in_scan: c = inclusive_scan(x[sig_in]) over n_pad slots, where
// slots whose source lies at or past the n_x real cells read 0 (padding,
// and the coarse level's masked in_sel slots).
// Replaces ops/accel.py::AccelPlan._accumulate_fused kernel k1 (r_in chain +
// flat prefix sum) and, on the tile plan's coarse level,
// _CoarseRouterSmall._route for r_in with the in_sel mask and the row-wise
// cumsum after it. Bound: 4 bytes of index + 2 * sizeof(T) per slot.
// Design: one pass, a scan with a look-back over a fixed window (after
// Merrill & Garland's decoupled look-back, NVIDIA 2016), the gather fused
// in. A block takes tile t of kTile slots through an atomic ticket (so every
// tile below t is held by a block that runs), loads src warp-striped
// (coalesced), gathers x, transposes through shared memory so each thread
// scans kPer consecutive slots, then warp shuffles and a scan of the warp
// totals give the tile's aggregate A(t), which it publishes at once. One
// warp then finds the tile's exclusive prefix in a fixed order:
//   E(t) = I(t - W) + R(t),  I(t) = I(t - W) + (R(t) + A(t)),
// R(t) the sum of A(t - W + 1 .. t - 1) by a fixed shuffle tree (K tiles a
// lane, W = 32 K; tiles below 0 and I of a tile below 0 give 0), and
// publishes the inclusive prefix I(t). Every sum is a fixed function of
// the data, never of timing: two calls give the same bits, in float64
// too. The wait chain is tiles / W hops; the W residue classes run side by
// side. A hop costs a round trip to L2: a published value and its flag
// share one 16-byte entry (two 8-byte words, each flag | 32 value bits),
// so one load finds both, and a lane loads all its entries before it
// looks at any. c goes out once, through shared memory again, coalesced:
// no pass reads it back. Launches: a memset of the entries and the
// ticket, and the kernel.
// Longest chain of additions to one c value (kernels.accel_in_scan_chain,
// _scan_len in chip_smoke.py): kPer in a thread, 5 over the warp's thread
// totals, 5 over the warp totals (A), K + 5 over the window (R), 2 for
// I(t) = I(t - W) + (R + A), one a hop over floor((tiles - 1) / W) hops,
// then the thread's offset and the slot:
//   L = kPer + K + 19 + floor((tiles - 1) / W).
// Every c is a sum with a +0 at its root, so no c is -0 (H2's differences
// then give the bits the earlier split far add gave). Integer types are
// exact (barring overflow); float32 is exact for integer-valued data whose
// running total stays below 2^24, the contract AccelPlan.accumulate keeps;
// float64 agrees within the rounding of the sums.
// ---------------------------------------------------------------------------
// threads, slots a thread, window tiles a lane and the blocks an SM the
// registers must leave room for, by value size
template <int S>
struct ScanCfg;
template <>
struct ScanCfg<4> {
  static constexpr int kThreads = 512, kPer = 16, kWin = 2, kMinBlocks = 2;
};
template <>
struct ScanCfg<8> {
  static constexpr int kThreads = 512, kPer = 8, kWin = 2, kMinBlocks = 2;
};

// a tile's published value: two words of (flag 1 << 32 | 32 value bits);
// all zero until published (the memset)
template <typename T>
__device__ __forceinline__ uint64_t to_bits(T v) {
  if constexpr (sizeof(T) == 4) {
    uint32_t u;
    memcpy(&u, &v, 4);
    return u;
  } else {
    uint64_t u;
    memcpy(&u, &v, 8);
    return u;
  }
}
template <typename T>
__device__ __forceinline__ T from_bits(uint64_t u) {
  T v;
  if constexpr (sizeof(T) == 4) {
    const uint32_t w = static_cast<uint32_t>(u);
    memcpy(&v, &w, 4);
  } else {
    memcpy(&v, &u, 8);
  }
  return v;
}
template <typename T>
__device__ __forceinline__ void publish(ulonglong2* e, T v) {
  const uint64_t u = to_bits(v);
  const uint64_t lo = (uint64_t{1} << 32) | (u & 0xffffffffu);
  const uint64_t hi = (uint64_t{1} << 32) | (u >> 32);
  asm volatile("st.relaxed.gpu.global.v2.b64 [%0], {%1, %2};" ::"l"(e), "l"(lo), "l"(hi)
               : "memory");
}
__device__ __forceinline__ ulonglong2 peek(const ulonglong2* e) {
  ulonglong2 w;
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];"
               : "=l"(w.x), "=l"(w.y)
               : "l"(e)
               : "memory");
  return w;
}
__device__ __forceinline__ bool ready(ulonglong2 w) {
  return (w.x >> 32) != 0 && (w.y >> 32) != 0;
}
template <typename T>
__device__ __forceinline__ T value(ulonglong2 w) {
  return from_bits<T>((w.x & 0xffffffffu) | (w.y << 32));
}

template <typename T>
__device__ __forceinline__ T shfl_down(T v, int off) {
  return __shfl_down_sync(0xffffffffu, v, off);
}
template <>
__device__ __forceinline__ int64_t shfl_down<int64_t>(int64_t v, int off) {
  return static_cast<int64_t>(
      __shfl_down_sync(0xffffffffu, static_cast<long long>(v), off));
}
template <typename T>
__device__ __forceinline__ T shfl_idx(T v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane);
}
template <>
__device__ __forceinline__ int64_t shfl_idx<int64_t>(int64_t v, int lane) {
  return static_cast<int64_t>(
      __shfl_sync(0xffffffffu, static_cast<long long>(v), lane));
}

// inclusive scan over a warp, shfl_up by 1, 2, 4, 8, 16: a fixed order
template <typename T>
__device__ __forceinline__ T warp_inclusive(T v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T y = shfl_up(v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// scratch of one call: the tiles' aggregate entries, their inclusive
// prefix entries, then the ticket; all zeroed before the kernel
inline int64_t scan_scratch_bytes(int64_t n_tiles) { return 32 * n_tiles + 16; }

template <typename T, int NT, int PER, int K, int MINB>
__global__ void __launch_bounds__(NT, MINB)
in_scan_kernel(const T* __restrict__ x, int64_t n_x,
               const int32_t* __restrict__ src, T* __restrict__ c, int64_t n,
               ulonglong2* __restrict__ agg, ulonglong2* __restrict__ inc,
               int* __restrict__ ticket) {
  constexpr int kTile = NT * PER;
  constexpr int kWarps = NT / 32;
  constexpr int kW = 32 * K;
  // one padding element every 128 bytes: the striped and the blocked
  // accesses of a warp fall in distinct banks
  constexpr int kRow = 128 / static_cast<int>(sizeof(T));
  __shared__ T sh[kTile + kTile / kRow];
  __shared__ T warp_sum[kWarps];
  __shared__ T tile_excl;
  __shared__ int64_t tile_id;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  auto pad = [](int q) { return q + q / kRow; };

  if (threadIdx.x == 0) tile_id = atomicAdd(ticket, 1);
  __syncthreads();
  const int64_t t = tile_id;
  const int64_t wbase = t * kTile + warp * 32 * PER;  // the warp's slots
  const int q0 = warp * 32 * PER;                     // ... in shared memory

  // striped: item i of a lane is slot wbase + 32 i + lane
  int32_t s[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int64_t p = wbase + 32 * i + lane;
    s[i] = p < n ? __ldg(src + p) : -1;
  }
  T v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = (s[i] >= 0 && s[i] < n_x) ? ldg(x + s[i]) : T(0);
#pragma unroll
  for (int i = 0; i < PER; ++i) sh[pad(q0 + 32 * i + lane)] = v[i];
  __syncwarp();
  // blocked: the lane's PER consecutive slots, scanned in registers
  T run = T(0);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    run += sh[pad(q0 + PER * lane + i)];
    v[i] = run;
  }
  const T incl = warp_inclusive(run, lane);
  T lane_excl = shfl_up(incl, 1);
  if (lane == 0) lane_excl = T(0);
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();

  if (warp == 0) {
    T w = lane < kWarps ? warp_sum[lane] : T(0);
    const T w_incl = warp_inclusive(w, lane);
    T w_excl = shfl_up(w_incl, 1);
    if (lane == 0) w_excl = T(0);
    const T a = shfl_idx(w_incl, kWarps - 1);  // the tile's aggregate
    if (lane == 0) publish(agg + t, a);
    // the window: lane l holds tiles t-1-(K l) .. t-K-(K l); the last of
    // lane 31 is t - W, whose inclusive prefix it reads instead. Every
    // entry is loaded before any is looked at: one round trip to L2 where
    // all are published
    bool need[K];
    ulonglong2 e[K];
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int64_t j = t - 1 - (static_cast<int64_t>(K) * lane + m);
      need[m] = j >= 0 && j > t - kW;
      e[m] = make_ulonglong2(0, 0);
    }
    bool need_i = lane == 31 && t >= kW;
    ulonglong2 ei = make_ulonglong2(0, 0);
    bool waiting = true;
    while (waiting) {
#pragma unroll
      for (int m = 0; m < K; ++m) {
        if (need[m]) e[m] = peek(agg + (t - 1 - (static_cast<int64_t>(K) * lane + m)));
      }
      if (need_i) ei = peek(inc + (t - kW));
      waiting = false;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        need[m] = need[m] && !ready(e[m]);
        waiting |= need[m];
      }
      need_i = need_i && !ready(ei);
      waiting |= need_i;
      if (waiting) __nanosleep(16);
    }
    T r = T(0);
#pragma unroll
    for (int m = 0; m < K; ++m) r += value<T>(e[m]);  // an unread entry reads 0
    T ipre = value<T>(ei);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) r += shfl_down(r, off);
    r = shfl_idx(r, 0);
    ipre = shfl_idx(ipre, 31);
    if (lane == 0) {
      publish(inc + t, ipre + (r + a));
      tile_excl = ipre + r;
    }
    if (lane < kWarps) warp_sum[lane] = w_excl;
  }
  __syncthreads();
  const T off = tile_excl + (warp_sum[warp] + lane_excl);
#pragma unroll
  for (int i = 0; i < PER; ++i) sh[pad(q0 + PER * lane + i)] = off + v[i];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int64_t p = wbase + 32 * i + lane;
    if (p < n) c[p] = sh[pad(q0 + 32 * i + lane)];
  }
}

template <typename T>
constexpr int scan_tile() {
  return ScanCfg<sizeof(T)>::kThreads * ScanCfg<sizeof(T)>::kPer;
}

// ---------------------------------------------------------------------------
// H2 accel_near_out: per preorder slot k,
//   outp[k] = (end[k] >= 0 ? c[end[k]] : 0) - (k > 0 ? c[k-1] : 0)
// the subtree sum of the node at slot k, whose interval ends at end[k] =
// k + size - 1 for every tree slot, near and far (-1 for padding and for
// slots whose sum no output reads).
// Replaces ops/accel.py::_accumulate_fused kernel k2 (the lane-window
// gather and _flat_prev) and the far ends of k3 (the r_exp chain, the
// b-block broadcast: the TPU's lane gather reaches only 128 lanes, so far
// ends went through routers); on the tile plan's coarse level
// _CoarseRouterSmall._gather_pair (two ops/router_big.py lane_gather_tiled
// calls and the flat shift) and the far ends of _far_values. Bound: 4 bytes
// of index + 2 * sizeof(T) per slot, plus a value per far end (near ends
// c[k+d], d < 128, lie in lines read anyway; far ends run in preorder,
// where a warp's slots are DFS neighbours and their ends cluster).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void near_out_kernel(const T* __restrict__ c,
                                const int32_t* __restrict__ near_end,
                                T* __restrict__ outp, int64_t n) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < n; k += stride) {
    int32_t e = near_end[k];
    T hi = e >= 0 ? ldg(c + e) : T(0);
    T lo = k > 0 ? ldg(c + k - 1) : T(0);
    outp[k] = hi - lo;
  }
}

// ---------------------------------------------------------------------------
// H3 accel_far_merge, the permute-merge: per output i,
//   res[i] = src_res[i] >= 0 ? outp[src_res[i]] : (x ? x[i] : 0)
// src_res the preorder slot of output i, -1 off the tree: preorder -> cells
// and the off-tree pass-through (x) or zero (x null) in one pass.
// Replaces ops/accel.py::_accumulate_fused's r_out route (k2's tail), the
// r_far chain of k3 and the XLA add and off-tree select after it
// (:290-291); on the tile plan's coarse level _CoarseRouterSmall._route of
// r_out, _far_values' r_far route and the tree_mask select (off-tree slots
// give 0). The far ends themselves moved into H2.
// Bound: 4 bytes of index + sizeof(T) written per output, sizeof(T) read
// per tree output, and per off-tree output where x passes through.
// Design: H0's layout (permute_gather_kernel): four outputs a thread
// strided by a block of 256, a block per 1,024 outputs, coalesced index
// loads and stores, four gathers in flight a thread.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
permute_merge_kernel(const T* __restrict__ outp, const T* __restrict__ x,
                     const int32_t* __restrict__ src, T* __restrict__ res,
                     int64_t n) {
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kGatherChunk + threadIdx.x;
  int32_t s[kGatherPer];
#pragma unroll
  for (int j = 0; j < kGatherPer; ++j) {
    const int64_t p = p0 + j * kThreads;
    s[j] = p < n ? __ldg(src + p) : 0;
  }
  T v[kGatherPer];
#pragma unroll
  for (int j = 0; j < kGatherPer; ++j) {
    const int64_t p = p0 + j * kThreads;
    if (s[j] >= 0) {
      v[j] = ldg(outp + s[j]);
    } else {
      v[j] = (x != nullptr && p < n) ? ldg(x + p) : T(0);
    }
  }
#pragma unroll
  for (int j = 0; j < kGatherPer; ++j) {
    const int64_t p = p0 + j * kThreads;
    if (p < n) res[p] = v[j];
  }
}

}  // namespace

extern "C" {

int pf_permute_gather(int dt, const void* x, const int32_t* src, void* out,
                      int64_t n, void* stream) {
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (n > 0) {
      const int64_t blocks = (n + kGatherChunk - 1) / kGatherChunk;  // n < 2^31
      permute_gather_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), src, static_cast<T*>(out), n);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// H1's geometry for element type dt: out[0] threads, out[1] slots a thread,
// out[2] the window W in tiles; -1 for an unknown dt
int pf_in_scan_geometry(int dt, int* out) {
  if (dt < 0 || dt > 3) return -1;
  const bool wide = dt >= 2;  // int64, float64
  out[0] = wide ? ScanCfg<8>::kThreads : ScanCfg<4>::kThreads;
  out[1] = wide ? ScanCfg<8>::kPer : ScanCfg<4>::kPer;
  out[2] = 32 * (wide ? ScanCfg<8>::kWin : ScanCfg<4>::kWin);
  return 0;
}

int pf_accel_in_scan(int dt, const void* x, int64_t n_x, const int32_t* src,
                     void* c, int64_t n, void* scratch, int64_t scratch_bytes,
                     void* stream) {
  if (n >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    using Cfg = ScanCfg<sizeof(T)>;
    const int64_t n_tiles = (n + scan_tile<T>() - 1) / scan_tile<T>();
    const int64_t bytes = scan_scratch_bytes(n_tiles);
    if (scratch_bytes < bytes || reinterpret_cast<uintptr_t>(scratch) % 16) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    ulonglong2* agg = static_cast<ulonglong2*>(scratch);
    cudaError_t err = cudaMemsetAsync(scratch, 0, bytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    in_scan_kernel<T, Cfg::kThreads, Cfg::kPer, Cfg::kWin, Cfg::kMinBlocks>
        <<<static_cast<unsigned>(n_tiles), Cfg::kThreads, 0, s>>>(
            static_cast<const T*>(x), n_x, src, static_cast<T*>(c), n, agg, agg + n_tiles,
            reinterpret_cast<int*>(agg + 2 * n_tiles));
    return static_cast<int>(cudaGetLastError());
  });
}

int pf_accel_near_out(int dt, const void* c, const int32_t* near_end,
                      void* outp, int64_t n, void* stream) {
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (n > 0) {
      near_out_kernel<T><<<grid_for(n, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(c), near_end, static_cast<T*>(outp), n);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

int pf_accel_far_merge(int dt, const void* outp, const void* x,
                       const int32_t* src_res, void* res, int64_t n, void* stream) {
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (n > 0) {
      const int64_t blocks = (n + kGatherChunk - 1) / kGatherChunk;  // n < 2^31
      permute_merge_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(outp), static_cast<const T*>(x), src_res,
          static_cast<T*>(res), n);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
