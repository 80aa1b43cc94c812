// Hopper (sm_90a) kernels of the hierarchical tile plan's upward sweep
// (T1, T2) and downward sweep (T3, T4) (pyflwdir_torch/ops/tile_plan.py).
//
// Built by pyflwdir_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes, once for each tile
// height 128 G (G = 1 to 4): this file for G = 1, and tile_kernels_g2.cu,
// _g3.cu and _g4.cu, which define PF_TILE_G and include it, a library each
// with the same entry points. Every entry takes an element-type code (1
// int32, 2 int64, 3 float64), device pointers and a cudaStream_t
// (PyTorch's current stream), launches, and returns cudaGetLastError();
// nothing here allocates or synchronises.
//
// The raster is cut into tiles of 128 G rows by 128 columns (T = 16,384 G
// cells). Each tile's flow forest has a DFS preorder of its own; every
// subtree is a preorder interval, so a subtree sum is a difference of two
// prefix sums. The JAX package moves values between raster and preorder
// layout with 5-stage (6 where G > 1) lane-gather routers
// (ops/tile_plan.py); here the plan composes each chain into one index per
// slot, relative to its tile, below T or -1, so int16 on the card where
// every value fits (G <= 2), int32 above (int32 on the host; n_tree int32):
//   rin[s]      raster cell (tile-local) of preorder slot s
//   ex_end[j]   preorder end of local root j (exits)
//   ent_idx[s]  packed rank of the last entry at a slot <= s, or -1
//   near_end[s] interval end of a near slot (end < s + 128), or -1
//   far_end[s]  interval end of a far slot, or -1
//   rout[l]     preorder slot of raster cell l, or -1 off the tree
// and for the downward sweep
//   es[q]       raster cell at position q of the tile's tree slots sorted
//               by (interval end, slot)
//   g_last[j]   sorted position of the last slot whose interval ends at j,
//               or -1 where none does
//   g_prev[j]   sorted position just before the first such slot, or -1
//   n_tree[t]   tree slots of tile t (they come first in preorder)
//   ent_slot[e] preorder slot of packed entry e, or -1 for padding
//   tree_of[s]  local tree (exit index) of slot s, or -1 off the tree
//
// A call runs on the tiles tile0 .. tile0 + NT - 1 of the raster's tile grid
// (ntx tiles a row): tile b of the call is tile tile0 + b of the grid,
// whose rows of the tables are the call's row b. x is always the (H, W)
// raster. The raster-side outputs (and T4's abar in lite mode) are the
// raster itself in a call on the whole grid (tile0 0, stack 0), or a tile
// stack, tile b's T cells at b * T in tile raster layout, in a call on a
// tile range (stack 1): the sharded sweep's layout, which ranges that start
// or end in the middle of a tile row gather cleanly. Cells past H or W read
// 0, and in a stack they are written (as 0 where they pass x through).
//
// A tile is G CTAs of 1024 threads, each with a 16,384-slot chunk of it in
// shared memory (64 KB of int32, 128 KB of int64/float64 a chunk-sized
// buffer; T3 holds up to 224 KB), above the 48 KB default, so the launch
// opts in with cudaFuncSetAttribute. At G = 1 that is one CTA a tile,
// launched plainly. Above, the G CTAs of a tile are one thread-block
// cluster (cudaLaunchKernelEx with a cluster dimension of (G, 1, 1), grid
// NT * G), and CTA r = cluster.block_rank() of tile b owns
//   - the preorder slots [16,384 r, 16,384 (r + 1)) of the tile, the
//     columns [16,384 r, ...) of its rows of the preorder-layout tables;
//   - the raster rows [128 r, 128 (r + 1)) of the tile, the same columns of
//     its rows of the tile-raster-layout tables (rout) and of a stack;
//   - a share of the tile's exits and entries (index j: r = (j / 1024) % G).
// Slot or cell i of the tile lies in CTA i >> 14 at i & 16383: a gather to
// any slot or cell reads the owner's shared memory through distributed
// shared memory (cluster.map_shared_rank). Each CTA scans its chunk as one
// CTA does a tile, then adds the chunk totals of the lower ranks in rank
// order (the higher ranks, for T3's suffix sum), read from their shared
// memory after a cluster barrier: every sum keeps one order, so two calls
// give the same bits. A phase that peers read ends with cluster.sync()
// before its buffer is reused, and a CTA leaves only after a last
// cluster.sync(). The first launch of each kernel (and, for T2, of a larger
// size) asks cudaOccupancyMaxActiveClusters whether a cluster fits (T3 in 8-byte
// values needs G SMs of one GPC with 224 KB free each); a launch that
// cannot run returns an error, and the wrapper raises.
//
// All four kernels move a few bytes per cell and do one or two adds on
// them: they are bound by device-memory bytes (3.35 TB/s on an H100 SXM),
// T3 by the latency of its dependent loads as well (and, in a cluster, of
// the remote shared-memory reads among them).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#ifndef PF_TILE_G
#define PF_TILE_G 1
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kG = PF_TILE_G;  // CTAs a tile: tiles of 128 kG rows
static_assert(kG >= 1 && kG <= 4, "tiles are 128 to 512 rows high");
constexpr int kLanes = 128;
constexpr int kTileRows = 128;              // rows of one CTA's chunk of a tile
constexpr int kSlots = kTileRows * kLanes;  // 16,384 slots (cells) a CTA
constexpr int kChunkBits = 14;              // log2(kSlots)
constexpr int kTileThreads = 1024;
constexpr int kWarps = kTileThreads / 32;
constexpr int kPerThread = kSlots / kTileThreads;  // 16
constexpr int kWarpSlots = kSlots / kWarps;        // 512
// T3 in 8-byte values: the chunks (of 8 a thread) whose u values wait in
// shared memory beside the staged tile, the rest in registers
constexpr int kDownStash = 6;

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
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
template <>
__device__ __forceinline__ int64_t shfl<int64_t>(int64_t v, int src) {
  return static_cast<int64_t>(
      __shfl_sync(0xffffffffu, static_cast<long long>(v), src));
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T y = shfl_up(v, off);
    if (lane >= off) v += y;
  }
  return v;
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
__device__ __forceinline__ T warp_inclusive_suffix_scan(T v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T y = shfl_down(v, off);
    if (lane + off < 32) v += y;
  }
  return v;
}

// value of tile-local raster cell l of the tile at (r0, c0); 0 past H or W
template <typename T>
__device__ __forceinline__ T tile_cell(const T* __restrict__ x, int64_t H,
                                       int64_t W, int64_t r0, int64_t c0,
                                       int l) {
  const int64_t r = r0 + (l >> 7);
  const int64_t col = c0 + (l & (kLanes - 1));
  return (r < H && col < W) ? x[r * W + col] : T(0);
}

// the raster tile at (r0, c0) into xs[0, kSlots), row-coalesced, 0 past H or W
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, int64_t H,
                                           int64_t W, int64_t r0, int64_t c0,
                                           T* xs) {
  for (int l = threadIdx.x; l < kSlots; l += kTileThreads) {
    xs[l] = tile_cell(x, H, W, r0, c0, l);
  }
}

// two values of adjacent slots, moved as one 8- or 16-byte access
template <typename T>
struct alignas(2 * sizeof(T)) Two {
  T x, y;
};

// the index tables: int16 where every slot of the tile fits, else int32
using Idx = std::conditional_t<(kG <= 2), int16_t, int32_t>;
// the table entries of slots 2j and 2j + 1, read as one word
using Word = std::conditional_t<(kG <= 2), uint32_t, Two<int32_t>>;

__device__ __forceinline__ const Word* words(const Idx* t) {
  return reinterpret_cast<const Word*>(t);
}
// the two int16 table entries of slots 2j (low half) and 2j + 1 in one word
__device__ __forceinline__ int lo16(uint32_t w) {
  return static_cast<int16_t>(w & 0xffffu);
}
__device__ __forceinline__ int hi16(uint32_t w) {
  return static_cast<int16_t>(w >> 16);
}
__device__ __forceinline__ int lo16(Two<int32_t> w) { return w.x; }
__device__ __forceinline__ int hi16(Two<int32_t> w) { return w.y; }
__device__ __forceinline__ uint32_t word_down(uint32_t w, int off) {
  return __shfl_down_sync(0xffffffffu, w, off);
}
__device__ __forceinline__ Two<int32_t> word_down(Two<int32_t> w, int off) {
  return Two<int32_t>{__shfl_down_sync(0xffffffffu, w.x, off),
                      __shfl_down_sync(0xffffffffu, w.y, off)};
}

// this CTA's rank in its tile's cluster
__device__ __forceinline__ int tile_rank() {
  if constexpr (kG == 1) {
    return 0;
  } else {
    return static_cast<int>(cg::this_cluster().block_rank());
  }
}

// a barrier of every thread of the tile, with its shared-memory writes
// visible to all of them
__device__ __forceinline__ void tile_sync() {
  if constexpr (kG == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// element i (a slot or cell of the tile, below kG * kSlots) of a buffer of
// which each CTA of the tile holds its kSlots chunk: the owner's shared
// memory, remote where the owner is another CTA of the cluster
template <typename T>
__device__ __forceinline__ T& tile_elem(T* buf, int i) {
  if constexpr (kG == 1) {
    return buf[i];
  } else {
    return *cg::this_cluster().map_shared_rank(buf + (i & (kSlots - 1)),
                                               i >> kChunkBits);
  }
}

// the sum, in rank order, of *v of the tile's CTAs q0 .. q1 - 1
template <typename T>
__device__ __forceinline__ T ranks_sum(T* v, int q0, int q1) {
  T s = T(0);
  for (int q = q0; q < q1; ++q) s += *cg::this_cluster().map_shared_rank(v, q);
  return s;
}

// copy the kSlots values at src in the shared memory of the tile's CTA q
// (src names the place in this CTA's own layout) to dst in this CTA's, 16
// bytes a load, every load of a thread issued before its stores
template <typename T>
__device__ __forceinline__ void copy_chunk_from(const T* src, int q, T* dst) {
  constexpr int kVec = kSlots * static_cast<int>(sizeof(T)) / 16 / kTileThreads;
  const int4* from = reinterpret_cast<const int4*>(
      cg::this_cluster().map_shared_rank(const_cast<T*>(src), q));
  int4* to = reinterpret_cast<int4*>(dst);
  int4 v[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = from[threadIdx.x + i * kTileThreads];
#pragma unroll
  for (int i = 0; i < kVec; ++i) to[threadIdx.x + i * kTileThreads] = v[i];
}

// where a CTA's work lies: its tile t of the call, the tile's first raster
// row y0, its own first row r0 and column c0, and the offset tb of its chunk
// in the tables' (and a stack's) rows
struct TilePos {
  int rank;
  int64_t t, y0, r0, c0, tb;
};
__device__ __forceinline__ TilePos tile_pos(int64_t ntx, int64_t tile0) {
  TilePos p;
  p.rank = tile_rank();
  p.t = blockIdx.x / kG;
  p.y0 = ((tile0 + p.t) / ntx) * (kTileRows * kG);
  p.r0 = p.y0 + p.rank * kTileRows;
  p.c0 = ((tile0 + p.t) % ntx) * kLanes;
  p.tb = (p.t * kG + p.rank) * kSlots;
  return p;
}

// where raster cell l of the tile at (r0, c0) goes in the call's raster-side
// arrays: cell l of block t's stack tile (kStack), or its place in the
// (H, W) raster, -1 past the raster's edge there
template <bool kStack>
__device__ __forceinline__ int64_t out_pos(int64_t tb, int64_t H, int64_t W,
                                           int64_t r0, int64_t c0, int l) {
  if constexpr (kStack) return tb + l;
  const int64_t r = r0 + (l >> 7);
  const int64_t col = c0 + (l & (kLanes - 1));
  return (r < H && col < W) ? r * W + col : -1;
}

// x at that cell (0 past the raster's edge, in a stack)
template <bool kStack, typename T>
__device__ __forceinline__ T cell_x(const T* __restrict__ x, int64_t g, int64_t H,
                                    int64_t W, int64_t r0, int64_t c0, int l) {
  if constexpr (kStack) return tile_cell(x, H, W, r0, c0, l);
  return x[g];
}

// set the kernel's dynamic shared memory, launch NT tiles of kG CTAs of
// kTileThreads on the stream (a cluster of kG CTAs a tile where kG > 1),
// return the launch error. A cluster must be resident on the card:
// cudaOccupancyMaxActiveClusters at the kernel's first launch at more
// shared memory than any before (only T2's grows, with E); the most that
// fit is remembered per kernel.
template <auto kernel, typename... A>
int launch_tiles(int64_t NT, int smem, void* stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (NT > 0) {
    if constexpr (kG == 1) {
      kernel<<<static_cast<unsigned>(NT), kTileThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(args...);
    } else {
      static std::atomic<int> fits{0};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = kG;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(static_cast<unsigned>(NT * kG), 1, 1);
      cfg.blockDim = dim3(kTileThreads, 1, 1);
      cfg.dynamicSmemBytes = static_cast<size_t>(smem);
      cfg.stream = static_cast<cudaStream_t>(stream);
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if (smem > fits.load()) {
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(
            &clusters, reinterpret_cast<const void*>(kernel), &cfg);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
        fits.store(smem);
      }
      err = cudaLaunchKernelEx(&cfg, kernel, args...);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// a kernel as a type, for launch_tiles' per-kernel state
template <auto F>
using Kern = std::integral_constant<decltype(F), F>;

template <typename T>
struct Tag {
  using type = T;
};

template <class F>
int by_dtype(int dt, F&& f) {
  switch (dt) {
    case 1: return f(Tag<int32_t>{});
    case 2: return f(Tag<int64_t>{});
    case 3: return f(Tag<double>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Inclusive prefix sum of a[0, n) in shared memory, n <= kSlots, by the
// whole block: each thread sums a contiguous run, a block scan of the run
// totals gives each run's offset. Ends with a barrier.
template <typename T>
__device__ void block_scan_inplace(T* a, int n, T* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (n + kTileThreads - 1) / kTileThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, n);
  T run = T(0);
  for (int i = lo; i < hi; ++i) run += a[i];
  T incl = warp_inclusive_scan(run, lane);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) warp_tot[lane] = warp_inclusive_scan(warp_tot[lane], lane);
  __syncthreads();
  T off = (incl - run) + (warp > 0 ? warp_tot[warp - 1] : T(0));
  for (int i = lo; i < hi; ++i) {
    off += a[i];
    a[i] = off;
  }
  __syncthreads();
}

// Inclusive prefix sum, in preorder, of the values of a CTA's 16,384 slots
// (the whole tile at G = 1), by the whole block: warp w owns slots
// [512 w, 512 w + 512) of the chunk, 32 at a
// time with a shuffle scan and a running carry; one warp scans the 32 warp
// totals. load(k) gives the value at slot tile_scan_slot(k) of the caller's
// thread; it is called once for each k, in order. On return v[k] holds the
// sum at that slot, and every load has been made (a barrier follows the last
// one), so the caller may overwrite what load read.
// The order of the additions is fixed: T1 and T2's full mode give the same
// bits for the same values.
__device__ __forceinline__ int tile_scan_slot(int k) {
  return (threadIdx.x >> 5) * kWarpSlots + (threadIdx.x & 31) + k * 32;
}

template <typename T, class Load>
__device__ __forceinline__ void tile_prefix_scan(Load load, T (&v)[kPerThread],
                                                 T* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T carry = T(0);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    T a = warp_inclusive_scan(load(k), lane) + carry;
    v[k] = a;
    carry = shfl(a, 31);
  }
  if (lane == 0) warp_tot[warp] = carry;
  __syncthreads();  // every load is done
  if (warp == 0) warp_tot[lane] = warp_inclusive_scan(warp_tot[lane], lane);
  __syncthreads();
  const T off = warp > 0 ? warp_tot[warp - 1] : T(0);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) v[k] += off;
}

// The raster cell of slot tile_scan_slot(k) of the caller's thread, from a
// CTA's chunk of a tile's rin row, for tile_prefix_scan's load(k), which it
// calls once for each k in order. From int16 tables a lane reads one 32-bit
// word for chunks k and k + 1 (k even), and lane l's cell of chunk k sits in
// lane l / 2's word, of chunk k + 1 in lane 16 + l / 2's: half the loads of
// an entry a lane. From int32 tables, one entry a lane.
template <typename I>
class ScanCellsOf;

template <>
class ScanCellsOf<int32_t> {
 public:
  __device__ explicit ScanCellsOf(const int32_t* rin_t) : rin_(rin_t) {}
  __device__ __forceinline__ int operator()(int k) { return rin_[tile_scan_slot(k)]; }

 private:
  const int32_t* rin_;
};

template <>
class ScanCellsOf<int16_t> {
 public:
  __device__ explicit ScanCellsOf(const int16_t* rin_t)
      : rin2_(reinterpret_cast<const uint32_t*>(rin_t)),
        w0_((threadIdx.x >> 5) * (kWarpSlots / 2) + (threadIdx.x & 31)) {}
  __device__ __forceinline__ int operator()(int k) {
    if ((k & 1) == 0) w_ = rin2_[w0_ + 16 * k];
    const int lane = threadIdx.x & 31;
    const uint32_t u = __shfl_sync(0xffffffffu, w_, (k & 1) * 16 + (lane >> 1));
    return (lane & 1) ? hi16(u) : lo16(u);
  }

 private:
  const uint32_t* rin2_;
  int w0_;
  uint32_t w_ = 0;
};

using ScanCells = ScanCellsOf<Idx>;

// ---------------------------------------------------------------------------
// T1 tile_pass_a: per tile t,
//   c[t, s]     = sum over slots s' <= s of x[cell(rin[t, s'])]
//   exits[t, j] = c[t, ex_end[t, j]] - (j > 0 ? c[t, ex_end[t, j-1]] : 0)
// where cells past the raster's H x W edge read 0.
// Replaces ops/tile_plan.py::TilePlan._pass_a_fused (_body_a_fused: the rin
// router chain, the Hillis-Steele tile prefix sum, the exit router and its
// prev-difference) and the jnp.pad copy before it; in exits-only mode
// (kEmitC false, no c written) TilePlan._pass_a / _pass_a_tiles (_body_a),
// the unfused pass A of the banded sweep; on a tile range,
// TilePlan._pass_a_tiles_fused (the sharded sweep's slab or chunk). Bound:
// x and rin read once, c written once: 2 * sizeof(T) + 2 bytes per slot
// (sizeof(T) + 2 without c), plus R_pad exits.
// Design: the block stages its 128 x 128 raster tile in shared memory with
// row-coalesced loads, gathers it into preorder through rin (coalesced
// index reads, a 32-bit word of two int16 entries a lane for two scan
// chunks, ScanCells; shared-memory gathers) and scans it (tile_prefix_scan):
// read an entry a lane, the 2-byte table timed slower on an H100 than the
// 4-byte one in float64 exits-only mode (PERF.md §6). The
// prefix sums are written to c and, over the dead raster tile, to shared
// memory, from which the exit differences are read. Summation order differs
// from the JAX package's (integers exact, float64 within rounding). In a
// cluster (128 G-row tiles) each CTA stages its 128 rows, gathers its chunk
// of slots from the owners' staged rows and adds the lower ranks' chunk
// totals; an exit end reads the owner's sums.
// ---------------------------------------------------------------------------
template <typename T, bool kEmitC>
__global__ void __launch_bounds__(kTileThreads)
    tile_pass_a_kernel(const T* __restrict__ x, int64_t H, int64_t W,
                       int64_t ntx, int64_t tile0,
                       const Idx* __restrict__ rin,
                       const Idx* __restrict__ ex_end, int R,
                       T* __restrict__ c, T* __restrict__ exits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  __shared__ T warp_tot[kWarps];
  const TilePos tp = tile_pos(ntx, tile0);
  stage_tile(x, H, W, tp.r0, tp.c0, xs);
  tile_sync();  // the whole tile is staged

  T v[kPerThread];
  ScanCells cell(rin + tp.tb);
  tile_prefix_scan([&](int k) { return tile_elem(xs, cell(k)); }, v, warp_tot);
  if constexpr (kG > 1) {
    // every gather from the staged tile is done; each CTA's chunk total is
    // its warp_tot[kWarps - 1]: add those of the lower ranks
    tile_sync();
    const T off = ranks_sum(&warp_tot[kWarps - 1], 0, tp.rank);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) v[k] += off;
  }
  T* c_t = c + tp.tb;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = tile_scan_slot(k);
    if (kEmitC) c_t[q] = v[k];
    xs[q] = v[k];
  }
  tile_sync();

  const Idx* ee = ex_end + tp.t * R;
  T* ex_t = exits + tp.t * R;
  for (int j = tp.rank * kTileThreads + threadIdx.x; j < R; j += kG * kTileThreads) {
    const T hi = tile_elem(xs, ee[j]);
    ex_t[j] = j > 0 ? hi - tile_elem(xs, ee[j - 1]) : hi;
  }
  if constexpr (kG > 1) tile_sync();  // peers may still read this CTA's sums
}

// ---------------------------------------------------------------------------
// T2 tile_pass_c: per tile t, with pc the inclusive prefix sum of the tile's
// E entry inflows (from the coarse level) and
//   c'[s]   = c[t, s] + (ent_idx[s] >= 0 ? pc[ent_idx[s]] : 0)
//   outp[s] = (near_end[s] >= 0 ? c'[near_end[s]] : 0) - (s > 0 ? c'[s-1] : 0)
//             + (far_end[s] >= 0 ? c'[far_end[s]] : 0)
//   out[cell(l)] = rout[l] >= 0 ? outp[rout[l]] : x[cell(l)]
// for every raster cell of the tile inside H x W. In full mode (kFull) c is
// not read: the kernel rebuilds it as T1 does, the prefix sum of
// x[cell(rin[t, s])] (tile_prefix_scan, the same bits).
// Replaces ops/tile_plan.py::TilePlan._pass_c_fused (_body_c_core: the
// entry step-injection, the near lane gathers, the far fexp router + b-block
// broadcast (or packed row-pair selection) + ffar router, the rout router
// and the off-tree passthrough); in full mode TilePlan._pass_c /
// _pass_c_tiles (_body_c: the rin chain and tile prefix sum first), the
// unfused pass C of the banded sweep; on a tile range,
// TilePlan._pass_c_tiles_fused. Bound: c (full mode: rin and every
// x), ent_idx, near_end, far_end, rout and x read once, out written once:
// 3 * sizeof(T) + 8 bytes per slot with 2-byte tables, plus the entries.
// Design: one block per tile, bound by device-memory bytes. The tables are
// 2 bytes a slot, and a thread reads them two slots at a time (one 32-bit
// word of two int16: slots 2j and 2j + 1), so each load instruction still
// moves 128 bytes a warp; c and out move as pairs of values too. The entries
// are scanned in shared memory; c' is built in shared memory; each thread
// holds its 16 outp values in registers across a barrier (c'[2j - 1] from the
// lane before by a shuffle) and writes them over c' in place; the raster
// tile is written row-coalesced through rout. Full mode reads rin as T1
// does (ScanCells). In 4-byte values it stages the 128 x 128 raster tile in
// shared memory with row-coalesced loads (in the buffer c' takes next, as
// T1 does: 64 KB) and gathers it there; in 8-byte values it gathers x from
// device memory through rin (the tile's 128 row segments stay in L1/L2),
// which timed faster on an H100 than staging its 128 KB (PERF.md §6).
// The off-tree passthrough reads x from device memory. With 4-byte values two blocks fit
// an SM's shared memory (66.5 KB each at E = 256): the launch bound holds
// the kernel to 32 registers a thread so that they fit its registers too
// (full mode too: two blocks an SM timed faster than one). In a cluster
// every CTA scans all the tile's entries; c' of a slot, its interval ends,
// the slot before the chunk and each routed cell's slot are read from the
// owner's chunk of c' or outp.
// ---------------------------------------------------------------------------
template <typename T, bool kFull, bool kStack>
__global__ void __launch_bounds__(kTileThreads, sizeof(T) == 4 ? 2 : 1)
    tile_pass_c_kernel(const T* __restrict__ x, int64_t H, int64_t W,
                       int64_t ntx, int64_t tile0, const T* __restrict__ c,
                       const Idx* __restrict__ rin,
                       const T* __restrict__ entv, int E,
                       const Idx* __restrict__ ent_idx,
                       const Idx* __restrict__ near_end,
                       const Idx* __restrict__ far_end,
                       const Idx* __restrict__ rout,
                       T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);
  Two<T>* cs2 = reinterpret_cast<Two<T>*>(smem_raw);
  T* pcs = cs + kSlots;
  __shared__ T warp_tot[kWarps];
  const TilePos tp = tile_pos(ntx, tile0);
  const int64_t tb = tp.tb;
  const int lane = threadIdx.x & 31;
  constexpr bool kStage = kFull && sizeof(T) == 4;  // full mode stages x

  if (E > 0) {  // every CTA of the tile scans all the tile's entries
    const T* ev = entv + tp.t * E;
    for (int i = threadIdx.x; i < E; i += kTileThreads) pcs[i] = ev[i];
  }
  if constexpr (kStage) stage_tile(x, H, W, tp.r0, tp.c0, cs);
  if constexpr (kStage && kG > 1) {
    tile_sync();  // the whole tile is staged
  } else {
    if (E > 0 || kStage) __syncthreads();
  }
  if (E > 0) block_scan_inplace(pcs, E, warp_tot);
  if constexpr (kFull) {
    T v[kPerThread];
    ScanCells cell(rin + tb);
    if constexpr (kStage) {
      tile_prefix_scan([&](int k) { return tile_elem(cs, cell(k)); }, v, warp_tot);
    } else {
      tile_prefix_scan(
          [&](int k) { return tile_cell(x, H, W, tp.y0, tp.c0, cell(k)); }, v,
          warp_tot);
    }
    if constexpr (kG > 1) {
      // every gather from the staged tile is done; add the lower ranks'
      // chunk totals
      tile_sync();
      const T off = ranks_sum(&warp_tot[kWarps - 1], 0, tp.rank);
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) v[k] += off;
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int s = tile_scan_slot(k);
      const int e = ent_idx[tb + s];
      cs[s] = e >= 0 ? v[k] + pcs[e] : v[k];
    }
  } else {
    const Two<T>* c2 = reinterpret_cast<const Two<T>*>(c + tb);
    const Word* ei2 = words(ent_idx + tb);
#pragma unroll
    for (int k = 0; k < kPerThread / 2; ++k) {
      const int j = threadIdx.x + k * kTileThreads;  // slots 2j, 2j + 1
      Two<T> v = c2[j];
      const Word w = ei2[j];
      const int e0 = lo16(w), e1 = hi16(w);
      if (e0 >= 0) v.x += pcs[e0];
      if (e1 >= 0) v.y += pcs[e1];
      cs2[j] = v;
    }
  }
  tile_sync();  // c' is whole in every CTA of the tile

  const Word* ne2 = words(near_end + tb);
  const Word* fe2 = words(far_end + tb);
  Two<T> o[kPerThread / 2];
#pragma unroll
  for (int k = 0; k < kPerThread / 2; ++k) {
    const int j = threadIdx.x + k * kTileThreads;  // slots 2j, 2j + 1
    const int jg = tp.rank * (kSlots / 2) + j;     // the pair in the tile
    const Two<T> cc = cs2[j];
    const T up = shfl_up(cc.y, 1);  // c'[2j - 1] of the lane before
    const T prev = lane > 0 ? up : (jg > 0 ? tile_elem(cs, 2 * jg - 1) : T(0));
    const Word wn = ne2[j], wf = fe2[j];
    const int n0 = lo16(wn), n1 = hi16(wn), f0 = lo16(wf), f1 = hi16(wf);
    T a = (n0 >= 0 ? tile_elem(cs, n0) : T(0)) - prev;
    if (f0 >= 0) a += tile_elem(cs, f0);
    T b = (n1 >= 0 ? tile_elem(cs, n1) : T(0)) - cc.x;
    if (f1 >= 0) b += tile_elem(cs, f1);
    o[k] = Two<T>{a, b};
  }
  tile_sync();  // every read of c' is done: overwrite it with outp
#pragma unroll
  for (int k = 0; k < kPerThread / 2; ++k) cs2[threadIdx.x + k * kTileThreads] = o[k];
  tile_sync();

  const Word* ro2 = words(rout + tb);
#pragma unroll
  for (int k = 0; k < kPerThread / 2; ++k) {
    const int j = threadIdx.x + k * kTileThreads;
    const Word w = ro2[j];
    const int q0 = lo16(w), q1 = hi16(w);
    const int l = 2 * j;  // cells l and l + 1: one row, adjacent columns
    if constexpr (kStack) {
      Two<T> v;
      v.x = q0 >= 0 ? tile_elem(cs, q0) : tile_cell(x, H, W, tp.r0, tp.c0, l);
      v.y = q1 >= 0 ? tile_elem(cs, q1) : tile_cell(x, H, W, tp.r0, tp.c0, l + 1);
      reinterpret_cast<Two<T>*>(out + tb)[j] = v;
    } else {
      const int64_t r = tp.r0 + (l >> 7);
      const int64_t col = tp.c0 + (l & (kLanes - 1));
      if (r < H && col < W) {
        const int64_t g = r * W + col;
        out[g] = q0 >= 0 ? tile_elem(cs, q0) : x[g];
        if (col + 1 < W) out[g + 1] = q1 >= 0 ? tile_elem(cs, q1) : x[g + 1];
      }
    }
  }
  if constexpr (kG > 1) tile_sync();  // peers may still read this CTA's outp
}

// ---------------------------------------------------------------------------
// T3 tile_down_a: pass D1 of the downward (transpose) sweep. Per tile t, with
// u[s] = x[cell(rin[t, s])] for the n_tree[t] tree slots s (0 after them)
// and end(k) the preorder interval end of slot k,
//   z[s] = sum of u[k] over the slots k <= s <= end(k)
// the sum of x over the path from slot s to its local root. Computed as
//   cs       = inclusive prefix sum of u in (end, slot) order (through es)
//   inner[j] = (g_last[j] >= 0 ? cs[g_last[j]] - (g_prev[j] >= 0 ? cs[g_prev[j]] : 0) : 0)
//              - u[j + 1]
//   z        = inclusive suffix sum of inner
// and pk[t, e] = ent_slot[t, e] >= 0 ? z[ent_slot[t, e]] : 0, the value at
// each entry cell of the tile. Raw mode writes z in preorder layout; routed
// mode writes the raster, out[cell(l)] = rout[l] >= 0 ? z[rout[l]] : x[cell(l)].
// Replaces ops/tile_plan.py::TilePlan._pass_down_raw (_body_down_raw) and,
// routed, TilePlan._pass_down (_body_down), on a tile range
// TilePlan._pass_down_tiles: the rin and es router chains, the
// tile prefix sum, the dea and deb boundary routers with their de_sel and
// de_b0 selects, the flat shift, the tile suffix sum, the enti chain and, routed, the
// rout chain and the off-tree passthrough; and the jnp.pad copy before them.
// Bound: x read and z (or out) written once, rin, es, g_last and g_prev (and
// rout) read once: 2 * sizeof(T) + 8 (+ 2) bytes per slot with 2-byte tables.
// Design: one block per tile, bound by the latency of its dependent loads
// (an index, then the value it names) more than by bytes. The block stages
// its 128 x 128 raster tile in shared memory with row-coalesced loads and
// gathers there. Each thread takes slot pairs, p = 256 w + 32 k + lane for
// warp w and k = 0 .. 7 (slots 2p, 2p + 1; warp w owns slots [512 w,
// 512 w + 512)): every table is read one 32-bit word of two int16 entries a
// pair, and each scan step covers 64 slots, half the loads and shuffles of a
// slot a thread. Both scans add a pair first, then scan the pair sums across
// the warp (shuffles), carry from chunk to chunk, and offset by the block
// scan of the warp totals; the suffix scan keeps warp totals of its own, so
// no barrier parts the two scans. cs goes to shared memory for the two
// boundary reads per slot. u[j + 1] comes from the staged tile: in 4-byte
// values the tile stays beside cs (two 64 KB buffers; the routed
// passthrough reads it too), in 8-byte ones (two 128 KB buffers would not
// fit) each thread reads its u values before cs overwrites the tile and
// keeps those of kDownStash of its 8 chunks in shared memory beside the
// buffer, the rest in registers (all in registers, they spilled). The
// launch bound names one block an SM: without it ptxas held the kernel to
// 50 registers, and it ran slower (PERF.md §6). Every sum has a fixed
// order: results are identical from run to run; integers equal the plain
// version bitwise, float64 within rounding (the scans add in another
// order). In a cluster the staged rows, cs and z are read from their
// owners (the cells of the tile's slots, the sorted run bounds, the next
// chunk's first u, the entry slots and the routed cells), the prefix scan
// adds the lower ranks' totals and the suffix scan the higher ranks'.
// Tiles of two CTAs in 4-byte values (kBulk) hold the whole tile in each
// CTA instead: both stage all 256 rows of x (128 KB; the peer's rows come
// from L2), so every x gather is local; each writes its chunk of cs over
// its own rows, and after one cluster barrier copies the peer's chunk in,
// 16 bytes a load, adding the lower chunk's total on read; z goes to a
// third buffer, which peers read where a slot lies in its chunk (copying
// the peer's z chunk in, as cs, was slower: PERF.md §6). Three cluster
// barriers instead of six; integer sums are exact in any order, so the
// bits are the same.
// ---------------------------------------------------------------------------
template <typename T, bool kRouted, bool kStack>
__global__ void __launch_bounds__(kTileThreads, 1)
    tile_down_a_kernel(const T* __restrict__ x, int64_t H, int64_t W,
                       int64_t ntx, int64_t tile0,
                       const Idx* __restrict__ rin,
                       const Idx* __restrict__ es,
                       const Idx* __restrict__ g_last,
                       const Idx* __restrict__ g_prev,
                       const int32_t* __restrict__ n_tree,
                       const Idx* __restrict__ ent_slot, int E,
                       const Idx* __restrict__ rout, T* __restrict__ z,
                       T* __restrict__ pk) {
  // two CTAs in 4-byte values: the whole tile in each CTA (xs: x, then cs;
  // zb: this chunk's z)
  constexpr bool kBulk = kG == 2 && sizeof(T) == 4;
  constexpr bool kKeep = sizeof(T) == 4 && !kBulk;  // the staged tile stays beside cs
  constexpr int kPairs = kPerThread / 2;
  // 8-byte values: the u values of chunks k < kStash wait in shared memory
  // beside cs, the others in registers (all of them in kBulk)
  constexpr int kStash = sizeof(T) == 4 ? 0 : kDownStash;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* zb = xs + kG * kSlots;  // kBulk only
  Two<T>* us2 = reinterpret_cast<Two<T>*>(xs + kSlots);  // the stashed u values
  __shared__ T warp_tot[kWarps];
  __shared__ T warp_suf[kWarps];
  const TilePos tp = tile_pos(ntx, tile0);
  const int64_t tb = tp.tb;
  const int nt = n_tree[tp.t];
  const int s0 = tp.rank * kSlots;  // the chunk's first slot in the tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p0 = warp * (kWarpSlots / 2) + lane;  // the pair of chunk k: p0 + 32 k
  const int u0 = warp * kStash * 32 + lane;       // its stash pair of chunk k: u0 + 32 k
  const Word* es2 = words(es + tb);
  const Word* gl2 = words(g_last + tb);
  const Word* gp2 = words(g_prev + tb);
  const Word* rin2 = words(rin + tb);
  T* cs = kKeep ? xs + kSlots : (kBulk ? xs + s0 : xs);
  Two<T>* cs2 = reinterpret_cast<Two<T>*>(cs);
  // x at cell i of the tile
  auto x_at = [&](int i) -> T {
    if constexpr (kBulk) {
      return xs[i];
    } else {
      return tile_elem(xs, i);
    }
  };

  if constexpr (kBulk) {
    for (int l = threadIdx.x; l < kG * kSlots; l += kTileThreads) {
      xs[l] = tile_cell(x, H, W, tp.y0, tp.c0, l);
    }
    __syncthreads();
  } else {
    stage_tile(x, H, W, tp.r0, tp.c0, xs);
    tile_sync();  // the whole tile is staged
  }

  // u at slots 2p + 1 and 2p + 2 (0 past the tree), from the staged tile;
  // the cell of slot 2p + 2 is the next pair's first: the next lane's, or
  // read by lane 31 (in the next CTA's chunk after the last pair)
  auto u_next = [&](int k, T& u1, T& u2) {
    const int p = p0 + 32 * k;
    const Word w = rin2[p];
    Word nx = word_down(w, 1);
    if (lane == 31) nx = s0 + 2 * p + 2 < nt ? rin2[p + 1] : Word{};
    u1 = s0 + 2 * p + 1 < nt ? x_at(hi16(w)) : T(0);
    u2 = s0 + 2 * p + 2 < nt ? x_at(lo16(nx)) : T(0);
  };
  T un1[kPairs - kStash], un2[kPairs - kStash];
  if constexpr (!kKeep) {
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      T u1, u2;
      u_next(k, u1, u2);
      if (k < kStash) {
        us2[u0 + 32 * k] = Two<T>{u1, u2};
      } else {
        un1[k >= kStash ? k - kStash : 0] = u1;
        un2[k >= kStash ? k - kStash : 0] = u2;
      }
    }
  }

  // prefix sums of the tree values in (end, slot) order
  T v0[kPairs], v1[kPairs];
  T carry = T(0);
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int p = p0 + 32 * k;
    const Word w = es2[p];
    const T a0 = s0 + 2 * p < nt ? x_at(lo16(w)) : T(0);
    const T a1 = s0 + 2 * p + 1 < nt ? x_at(hi16(w)) : T(0);
    const T b = a0 + a1;
    const T B = warp_inclusive_scan(b, lane);
    const T ex = shfl_up(B, 1);
    const T base = carry + (lane > 0 ? ex : T(0));
    v0[k] = base + a0;
    v1[k] = base + b;
    carry = carry + shfl(B, 31);
  }
  if (lane == 0) warp_tot[warp] = carry;
  __syncthreads();  // every read of the staged tile for the sorted values is done
  if (warp == 0) warp_tot[lane] = warp_inclusive_scan(warp_tot[lane], lane);
  __syncthreads();
  {
    T off = warp > 0 ? warp_tot[warp - 1] : T(0);
    if constexpr (kG > 1 && !kBulk) {
      // every CTA's reads of the staged tile for the sorted values are done
      // (in 8-byte values cs overwrites it); add the lower ranks' totals
      tile_sync();
      off += ranks_sum(&warp_tot[kWarps - 1], 0, tp.rank);
    }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) cs2[p0 + 32 * k] = Two<T>{v0[k] + off, v1[k] + off};
  }
  tile_sync();  // cs is whole in every CTA of the tile
  // kBulk: the chunks of cs without the lower chunk's total, which the
  // upper chunk's reads add
  T cs_off1 = T(0);
  if constexpr (kBulk) {
    cs_off1 = *cg::this_cluster().map_shared_rank(&warp_tot[kWarps - 1], 0);
    copy_chunk_from(xs + (1 - tp.rank) * kSlots, 1 - tp.rank, xs + (1 - tp.rank) * kSlots);
    __syncthreads();
  }
  auto cs_at = [&](int i) -> T {
    if constexpr (kBulk) {
      return xs[i] + ((i >> kChunkBits) ? cs_off1 : T(0));
    } else {
      return tile_elem(cs, i);
    }
  };

  // per-end group sums minus the next slot's value
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int p = p0 + 32 * k;
    const Word wl = gl2[p], wp = gp2[p];
    const int l0 = lo16(wl), l1 = hi16(wl), q0 = lo16(wp), q1 = hi16(wp);
    T g0 = T(0), g1 = T(0);
    if (l0 >= 0) {
      g0 = cs_at(l0);
      if (q0 >= 0) g0 -= cs_at(q0);
    }
    if (l1 >= 0) {
      g1 = cs_at(l1);
      if (q1 >= 0) g1 -= cs_at(q1);
    }
    T u1, u2;
    if constexpr (kKeep) {
      u_next(k, u1, u2);
    } else if (k < kStash) {
      const Two<T> u = us2[u0 + 32 * k];
      u1 = u.x;
      u2 = u.y;
    } else {
      u1 = un1[k >= kStash ? k - kStash : 0];
      u2 = un2[k >= kStash ? k - kStash : 0];
    }
    v0[k] = g0 - u1;
    v1[k] = g1 - u2;
  }

  // suffix sums, from the tile's last slot to its first
  carry = T(0);
#pragma unroll
  for (int k = kPairs - 1; k >= 0; --k) {
    const T d = v0[k] + v1[k];
    const T D = warp_inclusive_suffix_scan(d, lane);
    const T ex = shfl_down(D, 1);
    const T base = carry + (lane < 31 ? ex : T(0));
    v1[k] = base + v1[k];
    v0[k] = base + d;
    carry = carry + shfl(D, 0);
  }
  if (lane == 0) warp_suf[warp] = carry;
  __syncthreads();  // and every read of cs is done
  if (warp == 0) warp_suf[lane] = warp_inclusive_suffix_scan(warp_suf[lane], lane);
  __syncthreads();
  // kBulk: z of chunk 0 without chunk 1's suffix total, which its reads add
  T z_off0 = T(0);
  {
    T off = warp + 1 < kWarps ? warp_suf[warp + 1] : T(0);
    Two<T>* z2 = reinterpret_cast<Two<T>*>(z + tb);
    if constexpr (kBulk) {
      Two<T>* zb2 = reinterpret_cast<Two<T>*>(zb);
#pragma unroll
      for (int k = 0; k < kPairs; ++k) zb2[p0 + 32 * k] = Two<T>{v0[k] + off, v1[k] + off};
      tile_sync();  // every chunk of z and its suffix total is written
      z_off0 = *cg::this_cluster().map_shared_rank(&warp_suf[0], 1);
      if constexpr (!kRouted) {
        if (tp.rank == 0) off += z_off0;
#pragma unroll
        for (int k = 0; k < kPairs; ++k) z2[p0 + 32 * k] = Two<T>{v0[k] + off, v1[k] + off};
      }
    } else {
      if constexpr (kG > 1) {
        // every CTA's reads of cs are done (z overwrites it); add the higher
        // ranks' totals
        tile_sync();
        off += ranks_sum(&warp_suf[0], tp.rank + 1, kG);
      }
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const Two<T> zz{v0[k] + off, v1[k] + off};
        cs2[p0 + 32 * k] = zz;
        if (!kRouted) z2[p0 + 32 * k] = zz;
      }
    }
  }
  if constexpr (!kBulk) tile_sync();
  // z at slot i of the tile: in kBulk from the zb of the CTA whose chunk
  // holds it
  auto z_at = [&](int i) -> T {
    if constexpr (kBulk) {
      const int q = i >> kChunkBits;
      const T* zq = q == tp.rank ? zb + (i & (kSlots - 1))
                    : cg::this_cluster().map_shared_rank(zb + (i & (kSlots - 1)), q);
      return *zq + (q == 0 ? z_off0 : T(0));
    } else {
      return tile_elem(cs, i);
    }
  };

  const Idx* en = ent_slot + tp.t * E;
  T* pk_t = pk + tp.t * E;
  for (int e = tp.rank * kTileThreads + threadIdx.x; e < E; e += kG * kTileThreads) {
    const int sl = en[e];
    pk_t[e] = sl >= 0 ? z_at(sl) : T(0);
  }
  if constexpr (kRouted) {
    // raster cells 2j and 2j + 1 (one row, adjacent columns), one rout word
    const Word* ro2 = words(rout + tb);
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int j = threadIdx.x + k * kTileThreads;
      const Word w = ro2[j];
      const int qa = lo16(w), qb = hi16(w);
      const int l = 2 * j;
      if constexpr (kStack) {
        Two<T> v;
        if constexpr (kKeep) {
          v.x = qa >= 0 ? z_at(qa) : xs[l];
          v.y = qb >= 0 ? z_at(qb) : xs[l + 1];
        } else {
          v.x = qa >= 0 ? z_at(qa) : tile_cell(x, H, W, tp.r0, tp.c0, l);
          v.y = qb >= 0 ? z_at(qb) : tile_cell(x, H, W, tp.r0, tp.c0, l + 1);
        }
        reinterpret_cast<Two<T>*>(z + tb)[j] = v;
      } else {
        const int64_t r = tp.r0 + (l >> 7);
        const int64_t col = tp.c0 + (l & (kLanes - 1));
        if (r < H && col < W) {
          const int64_t g = r * W + col;
          if constexpr (kKeep) {
            z[g] = qa >= 0 ? z_at(qa) : xs[l];
            if (col + 1 < W) z[g + 1] = qb >= 0 ? z_at(qb) : xs[l + 1];
          } else {
            z[g] = qa >= 0 ? z_at(qa) : x[g];
            if (col + 1 < W) z[g + 1] = qb >= 0 ? z_at(qb) : x[g + 1];
          }
        }
      }
    }
  }
  if constexpr (kG > 1) tile_sync();  // peers may still read this CTA's z
}

// ---------------------------------------------------------------------------
// T4 tile_down_fin: pass D2 of the downward sweep. Per tile t and raster
// cell l inside H x W, with s = rout[t, l],
//   out[cell(l)] = s >= 0 ? z1[t, s] + (tree_of[t, s] >= 0 ? A[t, tree_of[t, s]] : 0)
//                         : x[cell(l)]
// where A[t, j] is the coarse level's path sum below local root j.
// Replaces ops/tile_plan.py::TilePlan._pass_down_fin (_body_down_fin: the
// exi router delivering the diff-encoded continuations to the root ends,
// the re_sel select, the tile suffix sum that spreads them over each tree,
// the rout chain and the off-tree passthrough). The TPU spreads A_j over
// tree j by a suffix sum of differences, exact only in wrapping integers;
// here each slot reads A by its tree index, exact in every type.
// Bound: z1, tree_of and rout read once, out written once, x read off the
// tree, A once per root: 2 * sizeof(T) + 4 bytes per slot.
// Design: one block per tile; z1 + A[tree] is built in shared memory from
// coalesced reads (A's row of the tile stays in L1), and the raster tile is
// written row-coalesced through rout. In a cluster each CTA builds its
// chunk and reads a routed cell's value from the slot's owner (lite mode:
// its tree index).
//
// Lite mode (kLite): the input is pass D1's routed result abar (T3 routed:
// z1 in raster order, x passed through off the tree), laid out as out, and
//   out[cell(l)] = abar[cell(l)] + (s >= 0 && tree_of[t, s] >= 0 ? A[t, tree_of[t, s]] : 0)
// with no add where the condition fails. Routing is a permutation and abar
// of a tree cell is z1[s], so lite mode gives fin mode's bits in every type.
// Replaces ops/tile_plan.py::TilePlan._pass_down_lite and, on a tile range,
// _pass_down_lite_tiles (_body_down_lite: the exi router, the re_sel select
// and suffix sum, the rout chain and the add on tree cells), pass D2 of the
// sharded downward sweep. Bound: abar read and out written once, rout and
// tree_of read once, A once per root: 2 * sizeof(T) + 4 bytes per cell.
// Design: one block per tile; the tile's tree_of row is staged in shared
// memory (32 KB) from coalesced reads, each raster cell reads its tree
// index there through rout and A from its tile's row (L1); abar and out
// move row-coalesced.
// ---------------------------------------------------------------------------
template <typename T, bool kLite, bool kStack>
__global__ void __launch_bounds__(kTileThreads)
    tile_down_fin_kernel(const T* __restrict__ x, int64_t H, int64_t W,
                         int64_t ntx, int64_t tile0, const T* __restrict__ z1,
                         const T* __restrict__ A, int R,
                         const Idx* __restrict__ tree_of,
                         const Idx* __restrict__ rout,
                         T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TilePos tp = tile_pos(ntx, tile0);
  const int64_t tb = tp.tb;
  const T* A_t = A + tp.t * R;
  if constexpr (kLite) {
    Idx* trs = reinterpret_cast<Idx*>(smem_raw);
    for (int s = threadIdx.x; s < kSlots; s += kTileThreads) {
      trs[s] = tree_of[tb + s];
    }
    tile_sync();
    for (int l = threadIdx.x; l < kSlots; l += kTileThreads) {
      const int64_t g = out_pos<kStack>(tb, H, W, tp.r0, tp.c0, l);
      if (g >= 0) {
        T v = z1[g];
        const int q = rout[tb + l];
        if (q >= 0) {
          const int tr = tile_elem(trs, q);
          if (tr >= 0) v += A_t[tr];
        }
        out[g] = v;
      }
    }
  } else {
    T* zs = reinterpret_cast<T*>(smem_raw);
    for (int s = threadIdx.x; s < kSlots; s += kTileThreads) {
      T v = z1[tb + s];
      const int tr = tree_of[tb + s];
      if (tr >= 0) v += A_t[tr];
      zs[s] = v;
    }
    tile_sync();
    for (int l = threadIdx.x; l < kSlots; l += kTileThreads) {
      const int64_t g = out_pos<kStack>(tb, H, W, tp.r0, tp.c0, l);
      if (g >= 0) {
        const int q = rout[tb + l];
        out[g] = q >= 0 ? tile_elem(zs, q) : cell_x<kStack>(x, g, H, W, tp.r0, tp.c0, l);
      }
    }
  }
  if constexpr (kG > 1) tile_sync();  // peers may still read this CTA's chunk
}

}  // namespace

extern "C" {

// largest dynamic shared memory a block of the tile kernels may use
int pf_tile_max_smem() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return optin - kWarps * 8;  // minus the static warp totals
}

// Every entry runs on the tiles tile0 .. tile0 + NT - 1 of the raster's
// grid of 128 kG x 128 tiles, its tables of Idx (NT, 16,384 kG); stack != 0:
// the raster-side outputs (and abar) are tile stacks.

// c == nullptr: exits only (no c written)
int pf_tile_pass_a(int dt, const void* x, int64_t H, int64_t W, int64_t NT,
                   int64_t ntx, int64_t tile0, const Idx* rin,
                   const Idx* ex_end, int64_t R, void* c, void* exits,
                   void* stream) {
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    auto launch = [&](auto k) {
      return launch_tiles<decltype(k)::value>(
          NT, kSlots * static_cast<int>(sizeof(T)), stream,
          static_cast<const T*>(x), H, W, ntx, tile0, rin, ex_end,
          static_cast<int>(R), static_cast<T*>(c), static_cast<T*>(exits));
    };
    return c != nullptr ? launch(Kern<tile_pass_a_kernel<T, true>>{})
                        : launch(Kern<tile_pass_a_kernel<T, false>>{});
  });
}

// c == nullptr: full mode, the prefix sums rebuilt from x through rin
int pf_tile_pass_c(int dt, const void* x, int64_t H, int64_t W, int64_t NT,
                   int64_t ntx, int64_t tile0, int stack, const void* c,
                   const Idx* rin, const void* entv, int64_t E,
                   const Idx* ent_idx, const Idx* near_end,
                   const Idx* far_end, const Idx* rout, void* out,
                   void* stream) {
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const int smem = (kSlots + static_cast<int>(E)) * static_cast<int>(sizeof(T));
    auto launch = [&](auto k) {
      return launch_tiles<decltype(k)::value>(
          NT, smem, stream, static_cast<const T*>(x), H, W, ntx, tile0,
          static_cast<const T*>(c), rin, static_cast<const T*>(entv),
          static_cast<int>(E), ent_idx, near_end, far_end, rout,
          static_cast<T*>(out));
    };
    if (c != nullptr) {
      return stack ? launch(Kern<tile_pass_c_kernel<T, false, true>>{})
                   : launch(Kern<tile_pass_c_kernel<T, false, false>>{});
    }
    return stack ? launch(Kern<tile_pass_c_kernel<T, true, true>>{})
                 : launch(Kern<tile_pass_c_kernel<T, true, false>>{});
  });
}

// routed != 0: z is the raster-side result (the raster or a tile stack);
// else the (NT, T) preorder z
int pf_tile_down_a(int dt, int routed, const void* x, int64_t H, int64_t W,
                   int64_t NT, int64_t ntx, int64_t tile0, int stack,
                   const Idx* rin, const Idx* es,
                   const Idx* g_last, const Idx* g_prev,
                   const int32_t* n_tree, const Idx* ent_slot, int64_t E,
                   const Idx* rout, void* z, void* pk, void* stream) {
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    // the staged tile and cs, or in 8-byte values one buffer for both and
    // the stashed u values; two CTAs in 4-byte values: the whole tile and z
    const int smem =
        static_cast<int>(sizeof(T)) *
        (kG == 2 && sizeof(T) == 4
             ? 3 * kSlots
             : kSlots + (sizeof(T) == 4 ? kSlots : 2 * kDownStash * kTileThreads));
    auto launch = [&](auto k) {
      return launch_tiles<decltype(k)::value>(
          NT, smem, stream, static_cast<const T*>(x), H, W, ntx, tile0, rin,
          es, g_last, g_prev, n_tree, ent_slot, static_cast<int>(E), rout,
          static_cast<T*>(z), static_cast<T*>(pk));
    };
    if (!routed) return launch(Kern<tile_down_a_kernel<T, false, false>>{});
    return stack ? launch(Kern<tile_down_a_kernel<T, true, true>>{})
                 : launch(Kern<tile_down_a_kernel<T, true, false>>{});
  });
}

// lite != 0: z1 is pass D1's routed result abar, laid out as out; x unused
int pf_tile_down_fin(int dt, int lite, const void* x, int64_t H, int64_t W,
                     int64_t NT, int64_t ntx, int64_t tile0, int stack,
                     const void* z1, const void* A, int64_t R,
                     const Idx* tree_of, const Idx* rout, void* out,
                     void* stream) {
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const int smem =
        kSlots * static_cast<int>(lite ? sizeof(Idx) : sizeof(T));
    auto launch = [&](auto k) {
      return launch_tiles<decltype(k)::value>(
          NT, smem, stream, static_cast<const T*>(x), H, W, ntx, tile0,
          static_cast<const T*>(z1), static_cast<const T*>(A),
          static_cast<int>(R), tree_of, rout, static_cast<T*>(out));
    };
    if (lite) {
      return stack ? launch(Kern<tile_down_fin_kernel<T, true, true>>{})
                   : launch(Kern<tile_down_fin_kernel<T, true, false>>{});
    }
    return stack ? launch(Kern<tile_down_fin_kernel<T, false, true>>{})
                 : launch(Kern<tile_down_fin_kernel<T, false, false>>{});
  });
}

}  // extern "C"
