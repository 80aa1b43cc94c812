// Hopper (sm_90a) kernels of the single-chunk router accumulation.
//
// Built by pyflwdir_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. Every entry takes device
// pointers and a cudaStream_t (PyTorch's current stream), launches, and
// returns cudaGetLastError(); nothing here allocates or synchronises.
//
// The JAX package expresses each static permutation as a 5-stage chain of
// 128-lane gathers because the TPU has no fast gather (ops/router.py). On
// Hopper a permutation is one int32 gather, so the plan composes every chain
// into a single index at load time and these kernels read it directly.
//
// All four kernels move a few bytes per element and do one or two flops on
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

// ---------------------------------------------------------------------------
// H0 permute_gather: out[p] = x[src[p]].
// Replaces ops/router.py::_ta (lane gather) and RouterPlan.apply (the
// L-S-G-S-L chain) of the JAX package. Bound: 12 bytes per element
// (4 index + 4 gathered + 4 written). Design: one thread per element with a
// grid-stride loop; src and out are coalesced, the gather goes through the
// read-only cache.
// ---------------------------------------------------------------------------
__global__ void permute_gather_kernel(const float* __restrict__ x,
                                      const int32_t* __restrict__ src,
                                      float* __restrict__ out, int64_t n) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < n; p += stride) {
    out[p] = __ldg(x + src[p]);
  }
}

// ---------------------------------------------------------------------------
// H1 accel_in_scan: c = inclusive_scan(x[sig_in]) over n_pad slots, where
// slots whose source lies past the n_x real cells read 0 (the padding).
// Replaces ops/accel.py::AccelPlan._accumulate_fused kernel k1 (r_in chain +
// flat prefix sum). Bound: 4 bytes index + 4 gathered + 4 written per slot.
// Design: three launches of a plain reduce-then-scan. A block of 512 threads
// scans a tile of 2048 slots (4 per thread, registers + warp shuffles) and
// writes its total; one block scans the totals; a third pass adds each
// tile's offset. Summation order differs from the TPU and the CPU: the
// result is exact (and so bitwise equal) only for integer-valued data whose
// running total stays below 2^24, the contract AccelPlan.accumulate keeps.
// ---------------------------------------------------------------------------
constexpr int kScanThreads = 512;
constexpr int kScanPerThread = 4;
constexpr int kScanTile = kScanThreads * kScanPerThread;  // 2048
constexpr int kTotalsThreads = 1024;

// Exclusive block scan of one value per thread; returns the thread's
// exclusive prefix and writes the block total to *total.
__device__ float block_exclusive_scan(float v, float* warp_sums, float* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < nwarps) warp_sums[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  float excl = (incl - v) + (warp > 0 ? warp_sums[warp - 1] : 0.0f);
  *total = warp_sums[nwarps - 1];
  return excl;
}

__global__ void scan_tiles_kernel(const float* __restrict__ x, int64_t n_x,
                                  const int32_t* __restrict__ src,
                                  float* __restrict__ c, int64_t n,
                                  float* __restrict__ tile_sums) {
  __shared__ float warp_sums[32];
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kScanTile + threadIdx.x * kScanPerThread;
  float v[kScanPerThread];
  float run = 0.0f;
#pragma unroll
  for (int j = 0; j < kScanPerThread; ++j) {
    int64_t p = base + j;
    float val = 0.0f;
    if (p < n) {
      int32_t s = src[p];
      val = s < n_x ? __ldg(x + s) : 0.0f;
    }
    run += val;
    v[j] = run;
  }
  float total;
  float off = block_exclusive_scan(run, warp_sums, &total);
#pragma unroll
  for (int j = 0; j < kScanPerThread; ++j) {
    int64_t p = base + j;
    if (p < n) c[p] = v[j] + off;
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block: exclusive scan of the tile totals in place.
__global__ void scan_totals_kernel(float* __restrict__ tile_sums, int64_t n_tiles) {
  __shared__ float warp_sums[32];
  const int64_t per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int64_t lo = threadIdx.x * per;
  float run = 0.0f;
  for (int64_t t = lo; t < lo + per && t < n_tiles; ++t) run += tile_sums[t];
  float total;
  float off = block_exclusive_scan(run, warp_sums, &total);
  __syncthreads();  // every thread has read its totals before any write
  for (int64_t t = lo; t < lo + per && t < n_tiles; ++t) {
    float s = tile_sums[t];
    tile_sums[t] = off;
    off += s;
  }
}

__global__ void add_tile_offsets_kernel(float* __restrict__ c, int64_t n,
                                        const float* __restrict__ tile_sums) {
  const float off = tile_sums[blockIdx.x];
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
// k2 (the lane-window gather and _flat_prev). Bound: 4 bytes index + 4 c[k]
// + 4 written per slot (the near end c[k+d], d < 128, hits the same lines).
// ---------------------------------------------------------------------------
__global__ void near_out_kernel(const float* __restrict__ c,
                                const int32_t* __restrict__ near_end,
                                float* __restrict__ outp, int64_t n) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < n; k += stride) {
    int32_t e = near_end[k];
    float hi = e >= 0 ? __ldg(c + e) : 0.0f;
    float lo = k > 0 ? __ldg(c + k - 1) : 0.0f;
    outp[k] = hi - lo;
  }
}

// ---------------------------------------------------------------------------
// H3 accel_far_merge: per cell i,
//   far_end[i] >= 0  -> res[i] = out[i] + c[far_end[i]]   (far interval)
//   far_end[i] == -1 -> res[i] = out[i]                    (near interval)
//   far_end[i] == -2 -> res[i] = x[i]                      (off-tree cell)
// Replaces ops/accel.py::_accumulate_fused kernel k3 (r_exp chain, b-block
// lane broadcast, r_far chain) plus the XLA add and off-tree passthrough
// after it: the plan composes r_exp, the broadcast and r_far into far_end.
// Bound: 4 index + 4 out + 4 x (off-tree only) + 4 written per cell, plus
// 4 bytes of c per far cell.
// ---------------------------------------------------------------------------
__global__ void far_merge_kernel(const float* __restrict__ out,
                                 const float* __restrict__ x,
                                 const float* __restrict__ c,
                                 const int32_t* __restrict__ far_end,
                                 float* __restrict__ res, int64_t n) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int32_t e = far_end[i];
    float v;
    if (e >= 0) {
      v = out[i] + __ldg(c + e);
    } else if (e == -1) {
      v = out[i];
    } else {
      v = x[i];
    }
    res[i] = v;
  }
}

}  // namespace

extern "C" {

int pf_scan_tile() { return kScanTile; }

int pf_permute_gather(const float* x, const int32_t* src, float* out, int64_t n,
                      void* stream) {
  if (n > 0) {
    permute_gather_kernel<<<grid_for(n, kThreads), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(x, src, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

int pf_accel_in_scan(const float* x, int64_t n_x, const int32_t* src, float* c,
                     int64_t n, float* tile_sums, int64_t n_tiles, void* stream) {
  if (n_tiles != (n + kScanTile - 1) / kScanTile || n_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  scan_tiles_kernel<<<n_tiles, kScanThreads, 0, s>>>(x, n_x, src, c, n, tile_sums);
  scan_totals_kernel<<<1, kTotalsThreads, 0, s>>>(tile_sums, n_tiles);
  add_tile_offsets_kernel<<<n_tiles, kScanThreads, 0, s>>>(c, n, tile_sums);
  return static_cast<int>(cudaGetLastError());
}

int pf_accel_near_out(const float* c, const int32_t* near_end, float* outp,
                      int64_t n, void* stream) {
  if (n > 0) {
    near_out_kernel<<<grid_for(n, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(c, near_end, outp, n);
  }
  return static_cast<int>(cudaGetLastError());
}

int pf_accel_far_merge(const float* out, const float* x, const float* c,
                       const int32_t* far_end, float* res, int64_t n,
                       void* stream) {
  if (n > 0) {
    far_merge_kernel<<<grid_for(n, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(out, x, c, far_end,
                                                            res, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
