// Hopper (sm_90a) kernels of the single-chunk router accumulation, also
// used by the tile plan's coarse level.
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
// All four kernels move a few bytes per element and do one or two adds on
// them: they are bound by device-memory bytes (3.35 TB/s on an H100 SXM),
// and at the Rhine-size plan (688,128 slots) by launch latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline int grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;  // grid-stride loops cover the rest
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
// L-S-G-S-L chain) of the JAX package, and on the tile plan's coarse level
// ops/tile_plan.py::_CoarseRouterSmall._route for r_out and, downward, for
// r_win, r_dea, r_deb and r_aout with the mask selects after them (a masked
// slot holds -1). Bound: 4 bytes of index + 2 * sizeof(T) per element. Design: one thread per element with a
// grid-stride loop; src and out are coalesced, the gather goes through the
// read-only cache.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void permute_gather_kernel(const T* __restrict__ x,
                                      const int32_t* __restrict__ src,
                                      T* __restrict__ out, int64_t n) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < n; p += stride) {
    const int32_t s = src[p];
    out[p] = s >= 0 ? ldg(x + s) : T(0);
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
// Design: three launches of a plain reduce-then-scan. A block of 512 threads
// scans a tile of 2048 slots (4 per thread, registers + warp shuffles) and
// writes its total; one block scans the totals; a third pass adds each
// tile's offset. Summation order differs from the TPU and the CPU: integer
// types are exact (barring overflow); float32 is exact only for
// integer-valued data whose running total stays below 2^24, the contract
// AccelPlan.accumulate keeps; float64 agrees within the rounding of the sums.
// ---------------------------------------------------------------------------
constexpr int kScanThreads = 512;
constexpr int kScanPerThread = 4;
constexpr int kScanTile = kScanThreads * kScanPerThread;  // 2048
constexpr int kTotalsThreads = 1024;

// Exclusive block scan of one value per thread; returns the thread's
// exclusive prefix and writes the block total to *total.
template <typename T>
__device__ T block_exclusive_scan(T v, T* warp_sums, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T y = shfl_up(incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? warp_sums[lane] : T(0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      T y = shfl_up(w, off);
      if (lane >= off) w += y;
    }
    if (lane < nwarps) warp_sums[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  T excl = (incl - v) + (warp > 0 ? warp_sums[warp - 1] : T(0));
  *total = warp_sums[nwarps - 1];
  return excl;
}

template <typename T>
__global__ void scan_tiles_kernel(const T* __restrict__ x, int64_t n_x,
                                  const int32_t* __restrict__ src,
                                  T* __restrict__ c, int64_t n,
                                  T* __restrict__ tile_sums) {
  __shared__ T warp_sums[32];
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kScanTile + threadIdx.x * kScanPerThread;
  T v[kScanPerThread];
  T run = T(0);
#pragma unroll
  for (int j = 0; j < kScanPerThread; ++j) {
    int64_t p = base + j;
    T val = T(0);
    if (p < n) {
      int32_t s = src[p];
      val = s < n_x ? ldg(x + s) : T(0);
    }
    run += val;
    v[j] = run;
  }
  T total;
  T off = block_exclusive_scan(run, warp_sums, &total);
#pragma unroll
  for (int j = 0; j < kScanPerThread; ++j) {
    int64_t p = base + j;
    if (p < n) c[p] = v[j] + off;
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block: exclusive scan of the tile totals in place.
template <typename T>
__global__ void scan_totals_kernel(T* __restrict__ tile_sums, int64_t n_tiles) {
  __shared__ T warp_sums[32];
  const int64_t per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int64_t lo = threadIdx.x * per;
  T run = T(0);
  for (int64_t t = lo; t < lo + per && t < n_tiles; ++t) run += tile_sums[t];
  T total;
  T off = block_exclusive_scan(run, warp_sums, &total);
  __syncthreads();  // every thread has read its totals before any write
  for (int64_t t = lo; t < lo + per && t < n_tiles; ++t) {
    T s = tile_sums[t];
    tile_sums[t] = off;
    off += s;
  }
}

template <typename T>
__global__ void add_tile_offsets_kernel(T* __restrict__ c, int64_t n,
                                        const T* __restrict__ tile_sums) {
  const T off = tile_sums[blockIdx.x];
  if (blockIdx.x == 0) return;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  for (int j = threadIdx.x; j < kScanTile; j += blockDim.x) {
    int64_t p = base + j;
    if (p < n) c[p] += off;
  }
}

// ---------------------------------------------------------------------------
// H2 accel_near_out: per preorder slot k,
//   outp[k] = (near_end[k] >= 0 ? c[near_end[k]] : 0) - (k > 0 ? c[k-1] : 0)
// i.e. the subtree sum for near intervals and -c[k-1] for far ones (their
// c[end] is added by H3 after the preorder -> cell permutation, H0).
// Replaces the near-interval half of ops/accel.py::_accumulate_fused kernel
// k2 (the lane-window gather and _flat_prev) and, on the tile plan's coarse
// level, _CoarseRouterSmall._gather_pair (two ops/router_big.py
// lane_gather_tiled calls and the flat shift). Bound: 4 bytes of index +
// 2 * sizeof(T) per slot (the near end c[k+d], d < 128, hits the same lines).
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
// H3 accel_far_merge: per cell i,
//   far_end[i] >= 0  -> res[i] = out[i] + c[far_end[i]]   (far interval)
//   far_end[i] == -1 -> res[i] = out[i]                    (near interval)
//   far_end[i] == -2 -> res[i] = off_zero ? 0 : x[i]       (off-tree cell)
// Replaces ops/accel.py::_accumulate_fused kernel k3 (r_exp chain, b-block
// lane broadcast, r_far chain) plus the XLA add and off-tree passthrough
// after it: the plan composes r_exp, the broadcast and r_far into far_end.
// On the tile plan's coarse level (off_zero = 1) it replaces
// _CoarseRouterSmall._far_values (r_exp route, row pair, lane_gather_tiled,
// r_far route) and the tree_mask select, where off-tree slots give 0.
// Bound: 4 index + sizeof(T) out + sizeof(T) written per cell, x per
// off-tree cell (off_zero = 0), c per far cell.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void far_merge_kernel(const T* __restrict__ out,
                                 const T* __restrict__ x,
                                 const T* __restrict__ c,
                                 const int32_t* __restrict__ far_end,
                                 T* __restrict__ res, int64_t n, int off_zero) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int32_t e = far_end[i];
    T v;
    if (e >= 0) {
      v = out[i] + ldg(c + e);
    } else if (e == -1) {
      v = out[i];
    } else {
      v = off_zero ? T(0) : x[i];
    }
    res[i] = v;
  }
}

}  // namespace

extern "C" {

int pf_scan_tile() { return kScanTile; }

int pf_permute_gather(int dt, const void* x, const int32_t* src, void* out,
                      int64_t n, void* stream) {
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (n > 0) {
      permute_gather_kernel<T><<<grid_for(n, kThreads), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), src, static_cast<T*>(out), n);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

int pf_accel_in_scan(int dt, const void* x, int64_t n_x, const int32_t* src,
                     void* c, int64_t n, void* tile_sums, int64_t n_tiles,
                     void* stream) {
  if (n_tiles != (n + kScanTile - 1) / kScanTile || n_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    T* cc = static_cast<T*>(c);
    T* ts = static_cast<T*>(tile_sums);
    scan_tiles_kernel<T><<<n_tiles, kScanThreads, 0, s>>>(
        static_cast<const T*>(x), n_x, src, cc, n, ts);
    scan_totals_kernel<T><<<1, kTotalsThreads, 0, s>>>(ts, n_tiles);
    add_tile_offsets_kernel<T><<<n_tiles, kScanThreads, 0, s>>>(cc, n, ts);
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

int pf_accel_far_merge(int dt, const void* out, const void* x, const void* c,
                       const int32_t* far_end, void* res, int64_t n,
                       int off_zero, void* stream) {
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (n > 0) {
      far_merge_kernel<T><<<grid_for(n, kThreads), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(out), static_cast<const T*>(x),
          static_cast<const T*>(c), far_end, static_cast<T*>(res), n,
          off_zero);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
