// Hopper (sm_90a) kernels of the hierarchical tile plan's upward sweep
// (T1, T2) and downward sweep (T3, T4) (pyflwdir_torch/ops/tile_plan.py).
//
// Built by pyflwdir_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. Every entry takes an
// element-type code (1 int32, 2 int64, 3 float64), device pointers and a
// cudaStream_t (PyTorch's current stream), launches, and returns
// cudaGetLastError(); nothing here allocates or synchronises.
//
// The raster is cut into 128 x 128 tiles (T = 16,384 cells). Each tile's
// flow forest has a DFS preorder of its own; every subtree is a preorder
// interval, so a subtree sum is a difference of two prefix sums. The JAX
// package moves values between raster and preorder layout with 5-stage
// lane-gather routers (ops/tile_plan.py); here the plan composes each
// chain into one int32 index per slot, relative to its tile:
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
// One CTA of 1024 threads per tile keeps the whole tile in shared memory
// (64 KB of int32, 128 KB of int64/float64, above the 48 KB default, so
// the launch opts in with cudaFuncSetAttribute). All four kernels move a
// few bytes per cell and do one or two adds on them: they are bound by
// device-memory bytes (3.35 TB/s on an H100 SXM).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kTileRows = 128;
constexpr int kSlots = kTileRows * kLanes;  // 16,384
constexpr int kTileThreads = 1024;
constexpr int kWarps = kTileThreads / 32;
constexpr int kPerThread = kSlots / kTileThreads;  // 16
constexpr int kWarpSlots = kSlots / kWarps;        // 512

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

// ---------------------------------------------------------------------------
// T1 tile_pass_a: per tile t,
//   c[t, s]     = sum over slots s' <= s of x[cell(rin[t, s'])]
//   exits[t, j] = c[t, ex_end[t, j]] - (j > 0 ? c[t, ex_end[t, j-1]] : 0)
// where cells past the raster's H x W edge read 0.
// Replaces ops/tile_plan.py::TilePlan._pass_a_fused (_body_a_fused: the rin
// router chain, the Hillis-Steele tile prefix sum, the exit router and its
// prev-difference) and the jnp.pad copy before it. Bound: x and rin read
// once, c written once: 2 * sizeof(T) + 4 bytes per slot, plus R_pad exits.
// Design: the block stages its 128 x 128 raster tile in shared memory with
// row-coalesced loads, gathers it into preorder through rin (coalesced
// index reads, shared-memory gathers), and scans it warp by warp: warp w
// owns slots [512 w, 512 w + 512), 32 at a time with a shuffle scan and a
// running carry; one warp scans the 32 warp totals. The prefix sums are
// written to c and, over the dead raster tile, to shared memory, from which
// the exit differences are read. Summation order differs from the JAX
// package's (integers exact, float64 within rounding).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    tile_pass_a_kernel(const T* __restrict__ x, int64_t H, int64_t W,
                       int64_t ntx, const int32_t* __restrict__ rin,
                       const int32_t* __restrict__ ex_end, int R,
                       T* __restrict__ c, T* __restrict__ exits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  __shared__ T warp_tot[kWarps];
  const int64_t t = blockIdx.x;
  const int64_t r0 = (t / ntx) * kTileRows;
  const int64_t c0 = (t % ntx) * kLanes;
  for (int l = threadIdx.x; l < kSlots; l += kTileThreads) {
    const int64_t r = r0 + (l >> 7);
    const int64_t col = c0 + (l & (kLanes - 1));
    xs[l] = (r < H && col < W) ? x[r * W + col] : T(0);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = warp * kWarpSlots + lane;
  const int32_t* rin_t = rin + t * kSlots;
  T v[kPerThread];
  T carry = T(0);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    T a = warp_inclusive_scan(xs[rin_t[base + k * 32]], lane) + carry;
    v[k] = a;
    carry = shfl(a, 31);
  }
  if (lane == 0) warp_tot[warp] = carry;
  __syncthreads();  // every gather from xs is done: xs may be overwritten
  if (warp == 0) warp_tot[lane] = warp_inclusive_scan(warp_tot[lane], lane);
  __syncthreads();
  const T off = warp > 0 ? warp_tot[warp - 1] : T(0);
  T* c_t = c + t * kSlots;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const T cv = v[k] + off;
    c_t[base + k * 32] = cv;
    xs[base + k * 32] = cv;
  }
  __syncthreads();

  const int32_t* ee = ex_end + t * R;
  T* ex_t = exits + t * R;
  for (int j = threadIdx.x; j < R; j += kTileThreads) {
    const T hi = xs[ee[j]];
    ex_t[j] = j > 0 ? hi - xs[ee[j - 1]] : hi;
  }
}

// ---------------------------------------------------------------------------
// T2 tile_pass_c: per tile t, with pc the inclusive prefix sum of the tile's
// E entry inflows (from the coarse level) and
//   c'[s]   = c[t, s] + (ent_idx[s] >= 0 ? pc[ent_idx[s]] : 0)
//   outp[s] = (near_end[s] >= 0 ? c'[near_end[s]] : 0) - (s > 0 ? c'[s-1] : 0)
//             + (far_end[s] >= 0 ? c'[far_end[s]] : 0)
//   out[cell(l)] = rout[l] >= 0 ? outp[rout[l]] : x[cell(l)]
// for every raster cell of the tile inside H x W.
// Replaces ops/tile_plan.py::TilePlan._pass_c_fused (_body_c_core: the
// entry step-injection, the near lane gathers, the far fexp router + b-block
// broadcast (or packed row-pair selection) + ffar router, the rout router
// and the off-tree passthrough). Bound: c, ent_idx, near_end, far_end, rout
// and x read once, out written once: 3 * sizeof(T) + 16 bytes per slot,
// plus the entries.
// Design: one block per tile; the entries are scanned in shared memory,
// c' is built in shared memory from coalesced reads, each thread holds its
// 16 outp values in registers across a barrier and writes them over c' in
// place, and the raster tile is written row-coalesced through rout.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    tile_pass_c_kernel(const T* __restrict__ x, int64_t H, int64_t W,
                       int64_t ntx, const T* __restrict__ c,
                       const T* __restrict__ entv, int E,
                       const int32_t* __restrict__ ent_idx,
                       const int32_t* __restrict__ near_end,
                       const int32_t* __restrict__ far_end,
                       const int32_t* __restrict__ rout,
                       T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);
  T* pcs = cs + kSlots;
  __shared__ T warp_tot[kWarps];
  const int64_t t = blockIdx.x;
  const int64_t r0 = (t / ntx) * kTileRows;
  const int64_t c0 = (t % ntx) * kLanes;
  const int64_t tb = t * kSlots;

  if (E > 0) {
    const T* ev = entv + t * E;
    for (int i = threadIdx.x; i < E; i += kTileThreads) pcs[i] = ev[i];
    __syncthreads();
    block_scan_inplace(pcs, E, warp_tot);
  }
  for (int s = threadIdx.x; s < kSlots; s += kTileThreads) {
    T v = c[tb + s];
    const int32_t e = ent_idx[tb + s];
    if (e >= 0) v += pcs[e];
    cs[s] = v;
  }
  __syncthreads();

  T o[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int s = threadIdx.x + k * kTileThreads;
    const int32_t ne = near_end[tb + s];
    const int32_t fe = far_end[tb + s];
    T val = (ne >= 0 ? cs[ne] : T(0)) - (s > 0 ? cs[s - 1] : T(0));
    if (fe >= 0) val += cs[fe];
    o[k] = val;
  }
  __syncthreads();  // every read of c' is done: overwrite it with outp
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) cs[threadIdx.x + k * kTileThreads] = o[k];
  __syncthreads();

  for (int l = threadIdx.x; l < kSlots; l += kTileThreads) {
    const int64_t r = r0 + (l >> 7);
    const int64_t col = c0 + (l & (kLanes - 1));
    if (r < H && col < W) {
      const int64_t g = r * W + col;
      const int32_t q = rout[tb + l];
      out[g] = q >= 0 ? cs[q] : x[g];
    }
  }
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
// routed, TilePlan._pass_down (_body_down): the rin and es router chains, the
// tile prefix sum, the dea and deb boundary routers with their de_sel and
// de_b0 selects, the flat shift, the tile suffix sum, the enti chain and, routed, the
// rout chain and the off-tree passthrough; and the jnp.pad copy before them.
// Bound: x read and z (or out) written once, rin, es, g_last and g_prev (and
// rout) read once: 2 * sizeof(T) + 16 (+ 4) bytes per slot in this layout.
// Design: one block per tile and one shared-memory tile, as T1. The sorted
// values are gathered straight from x (the tile's 128 row segments stay in
// L1/L2) and scanned in registers warp by warp as in T1; cs goes to shared
// memory for the two boundary reads per slot; u[j + 1] is a second gather
// from x; the suffix scan mirrors the prefix scan (shuffle down, carry from
// the last chunk to the first, warp totals scanned from the right). Two
// T-sized buffers of 8-byte values would not fit 227 KB, hence the gathers
// from device memory instead of a staged raster tile. Every sum has a fixed
// order: results are identical from run to run; integers equal the plain
// version bitwise, float64 within rounding (the scans add in another order).
// ---------------------------------------------------------------------------
template <typename T, bool kRouted>
__global__ void __launch_bounds__(kTileThreads)
    tile_down_a_kernel(const T* __restrict__ x, int64_t H, int64_t W,
                       int64_t ntx, const int32_t* __restrict__ rin,
                       const int32_t* __restrict__ es,
                       const int32_t* __restrict__ g_last,
                       const int32_t* __restrict__ g_prev,
                       const int32_t* __restrict__ n_tree,
                       const int32_t* __restrict__ ent_slot, int E,
                       const int32_t* __restrict__ rout, T* __restrict__ z,
                       T* __restrict__ pk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);
  __shared__ T warp_tot[kWarps];
  const int64_t t = blockIdx.x;
  const int64_t r0 = (t / ntx) * kTileRows;
  const int64_t c0 = (t % ntx) * kLanes;
  const int64_t tb = t * kSlots;
  const int nt = n_tree[t];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = warp * kWarpSlots + lane;

  // prefix sums of the tree values in (end, slot) order
  T v[kPerThread];
  T carry = T(0);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = base + k * 32;
    T a = q < nt ? tile_cell(x, H, W, r0, c0, es[tb + q]) : T(0);
    a = warp_inclusive_scan(a, lane) + carry;
    v[k] = a;
    carry = shfl(a, 31);
  }
  if (lane == 0) warp_tot[warp] = carry;
  __syncthreads();
  if (warp == 0) warp_tot[lane] = warp_inclusive_scan(warp_tot[lane], lane);
  __syncthreads();
  {
    const T off = warp > 0 ? warp_tot[warp - 1] : T(0);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) cs[base + k * 32] = v[k] + off;
  }
  __syncthreads();

  // per-end group sums minus the next slot's value
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int s = base + k * 32;
    const int32_t gl = g_last[tb + s];
    T g = T(0);
    if (gl >= 0) {
      g = cs[gl];
      const int32_t gp = g_prev[tb + s];
      if (gp >= 0) g -= cs[gp];
    }
    const T un =
        s + 1 < nt ? tile_cell(x, H, W, r0, c0, rin[tb + s + 1]) : T(0);
    v[k] = g - un;
  }
  __syncthreads();  // every read of cs and of the warp totals is done

  // suffix sums, from the tile's last slot to its first
  carry = T(0);
#pragma unroll
  for (int k = kPerThread - 1; k >= 0; --k) {
    const T a = warp_inclusive_suffix_scan(v[k], lane) + carry;
    v[k] = a;
    carry = shfl(a, 0);
  }
  if (lane == 0) warp_tot[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    warp_tot[lane] = warp_inclusive_suffix_scan(warp_tot[lane], lane);
  }
  __syncthreads();
  {
    const T off = warp + 1 < kWarps ? warp_tot[warp + 1] : T(0);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int s = base + k * 32;
      const T zz = v[k] + off;
      cs[s] = zz;
      if (!kRouted) z[tb + s] = zz;
    }
  }
  __syncthreads();

  const int32_t* en = ent_slot + t * E;
  T* pk_t = pk + t * E;
  for (int e = threadIdx.x; e < E; e += kTileThreads) {
    const int32_t sl = en[e];
    pk_t[e] = sl >= 0 ? cs[sl] : T(0);
  }
  if (kRouted) {
    for (int l = threadIdx.x; l < kSlots; l += kTileThreads) {
      const int64_t r = r0 + (l >> 7);
      const int64_t col = c0 + (l & (kLanes - 1));
      if (r < H && col < W) {
        const int64_t g = r * W + col;
        const int32_t q = rout[tb + l];
        z[g] = q >= 0 ? cs[q] : x[g];
      }
    }
  }
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
// tree, A once per root: 2 * sizeof(T) + 8 bytes per slot in this layout.
// Design: one block per tile; z1 + A[tree] is built in shared memory from
// coalesced reads (A's row of the tile stays in L1), and the raster tile is
// written row-coalesced through rout.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    tile_down_fin_kernel(const T* __restrict__ x, int64_t H, int64_t W,
                         int64_t ntx, const T* __restrict__ z1,
                         const T* __restrict__ A, int R,
                         const int32_t* __restrict__ tree_of,
                         const int32_t* __restrict__ rout,
                         T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* zs = reinterpret_cast<T*>(smem_raw);
  const int64_t t = blockIdx.x;
  const int64_t r0 = (t / ntx) * kTileRows;
  const int64_t c0 = (t % ntx) * kLanes;
  const int64_t tb = t * kSlots;
  const T* A_t = A + t * R;
  for (int s = threadIdx.x; s < kSlots; s += kTileThreads) {
    T v = z1[tb + s];
    const int32_t tr = tree_of[tb + s];
    if (tr >= 0) v += A_t[tr];
    zs[s] = v;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < kSlots; l += kTileThreads) {
    const int64_t r = r0 + (l >> 7);
    const int64_t col = c0 + (l & (kLanes - 1));
    if (r < H && col < W) {
      const int64_t g = r * W + col;
      const int32_t q = rout[tb + l];
      out[g] = q >= 0 ? zs[q] : x[g];
    }
  }
}

template <typename T, bool kRouted>
int launch_tile_down_a(const void* x, int64_t H, int64_t W, int64_t NT,
                       int64_t ntx, const int32_t* rin, const int32_t* es,
                       const int32_t* g_last, const int32_t* g_prev,
                       const int32_t* n_tree, const int32_t* ent_slot,
                       int64_t E, const int32_t* rout, void* z, void* pk,
                       void* stream) {
  const int smem = kSlots * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      tile_down_a_kernel<T, kRouted>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (NT > 0) {
    tile_down_a_kernel<T, kRouted>
        <<<static_cast<unsigned>(NT), kTileThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), H, W, ntx, rin, es, g_last, g_prev,
            n_tree, ent_slot, static_cast<int>(E), rout, static_cast<T*>(z),
            static_cast<T*>(pk));
  }
  return static_cast<int>(cudaGetLastError());
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

int pf_tile_pass_a(int dt, const void* x, int64_t H, int64_t W, int64_t NT,
                   int64_t ntx, const int32_t* rin, const int32_t* ex_end,
                   int64_t R, void* c, void* exits, void* stream) {
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const int smem = kSlots * static_cast<int>(sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(
        tile_pass_a_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (NT > 0) {
      tile_pass_a_kernel<T><<<static_cast<unsigned>(NT), kTileThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), H, W, ntx, rin, ex_end, static_cast<int>(R),
          static_cast<T*>(c), static_cast<T*>(exits));
    }
    return static_cast<int>(cudaGetLastError());
  });
}

int pf_tile_pass_c(int dt, const void* x, int64_t H, int64_t W, int64_t NT,
                   int64_t ntx, const void* c, const void* entv, int64_t E,
                   const int32_t* ent_idx, const int32_t* near_end,
                   const int32_t* far_end, const int32_t* rout, void* out,
                   void* stream) {
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const int smem = (kSlots + static_cast<int>(E)) * static_cast<int>(sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(
        tile_pass_c_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (NT > 0) {
      tile_pass_c_kernel<T><<<static_cast<unsigned>(NT), kTileThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), H, W, ntx, static_cast<const T*>(c),
          static_cast<const T*>(entv), static_cast<int>(E), ent_idx, near_end,
          far_end, rout, static_cast<T*>(out));
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// routed != 0: z is the (H*W,) raster result; else the (NT, 16384) preorder z
int pf_tile_down_a(int dt, int routed, const void* x, int64_t H, int64_t W,
                   int64_t NT, int64_t ntx, const int32_t* rin,
                   const int32_t* es, const int32_t* g_last,
                   const int32_t* g_prev, const int32_t* n_tree,
                   const int32_t* ent_slot, int64_t E, const int32_t* rout,
                   void* z, void* pk, void* stream) {
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return routed ? launch_tile_down_a<T, true>(x, H, W, NT, ntx, rin, es,
                                                g_last, g_prev, n_tree,
                                                ent_slot, E, rout, z, pk, stream)
                  : launch_tile_down_a<T, false>(x, H, W, NT, ntx, rin, es,
                                                 g_last, g_prev, n_tree,
                                                 ent_slot, E, rout, z, pk,
                                                 stream);
  });
}

int pf_tile_down_fin(int dt, const void* x, int64_t H, int64_t W, int64_t NT,
                     int64_t ntx, const void* z1, const void* A, int64_t R,
                     const int32_t* tree_of, const int32_t* rout, void* out,
                     void* stream) {
  return by_dtype(dt, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const int smem = kSlots * static_cast<int>(sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(
        tile_down_fin_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (NT > 0) {
      tile_down_fin_kernel<T><<<static_cast<unsigned>(NT), kTileThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), H, W, ntx, static_cast<const T*>(z1),
          static_cast<const T*>(A), static_cast<int>(R), tree_of, rout,
          static_cast<T*>(out));
    }
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
