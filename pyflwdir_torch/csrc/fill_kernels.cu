// Hopper (sm_90a) kernel of the device depression fill: F1 fill_sweep, one
// row-sequential Gauss-Seidel sweep of reconstruction by erosion.
//
// Built by pyflwdir_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. The entry takes device
// pointers and a cudaStream_t (PyTorch's current stream), launches the
// kernel and returns cudaGetLastError(); nothing here allocates or
// synchronises.
//
// Replaces ops/fill.py::_sweep_strip of the JAX package (pallas_call
// :239): the same recurrence as its XLA _sweep. For each row r in sweep
// order (top to bottom, or bottom to top for the up sweep; the columns are
// never flipped):
//   m_up[c] = min(prev[c-1], prev[c], prev[c+1])  (conn 8; prev[c] for 4),
//             prev the row just finished, +inf off the grid and before the
//             first row
//   b[c]    = min(w[r][c], m_up[c])
//   fwd[c]  = max(d[c], min(b[c], fwd[c-1]))             west -> east
//   rev[c]  = max(d[c], min(min(b[c], fwd[c]), rev[c+1])) east -> west
//   out[c]  = fixed[c] ? w[r][c] : max(min(fwd[c], rev[c]), d[c])
// Each scan is an inclusive scan of clamp maps x -> max(a, min(b, x)),
// closed under composition (left map applied first):
//   (a1, b1) then (a2, b2) = (max(a2, min(b2, a1)), min(b1, b2)),
// identity (-inf, +inf). Only max and min are applied, so every grouping of
// the scan gives the same bits as the plain version and the JAX package.
// Inputs are NaN-free: nodata cells are +inf in d and fixed.
//
// Bound: one sweep reads w, d and the mask once and writes w once, 13 bytes
// a cell (0.14 ms at 36 M cells over 3.35 TB/s), and does about a dozen
// min/max a cell. What the bound ignores is the chain: each row needs the
// row before it, so a sweep is nrow dependent row steps.
//
// Design (simple first): ONE thread block runs the whole sweep; the row
// loop inside the block takes the place of the TPU's sequential grid of
// 64-row strips (blocks run in no order, so no carry may cross them, and a
// split of the rows would change the Gauss-Seidel order and so the sweep's
// output). 512 threads; thread t owns the contiguous columns [t K, t K + K),
// K = ceil(ncol / 512). Per row a thread composes its clamp maps in
// registers, the block scans the 512 (a, b) pairs (warp shuffles, then the
// 16 warp totals in shared memory), and the thread walks its columns again
// from its exclusive prefix; the east -> west scan is the mirror image.
// Up to kStageCols columns the previous row, b and the current row's d, w
// and mask live in shared memory (26 bytes a column, 213 KB at 8,192), and
// row r + 1 is loaded into registers, coalesced, while row r is scanned.
// Wider rows read the previous row back from the output and keep b in a
// device-memory scratch row. Any ncol works: nothing is padded, the last
// threads own short or empty runs. Left for later: several SMs on one row
// (thread block clusters), TMA loads, bank-conflict-free column runs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFillThreads = 512;
constexpr int kFillWarps = kFillThreads / 32;
constexpr int kStagePer = 16;                            // staged columns a thread loads
constexpr int kStageCols = kFillThreads * kStagePer;     // 8,192
constexpr size_t kStageBytesPerCol = 6 * sizeof(float) + 2;  // P, B, 2 x (d, w), 2 x mask

struct Clamp {
  float a, b;
};

__device__ __forceinline__ Clamp clamp_id() { return {-INFINITY, INFINITY}; }

// l applied first, then r (the JAX package's _clamp_combine(left, right))
__device__ __forceinline__ Clamp compose(Clamp l, Clamp r) {
  return {fmaxf(r.a, fminf(r.b, l.a)), fminf(l.b, r.b)};
}

// the map applied to +inf: the value after a run that starts off the grid
__device__ __forceinline__ float at_inf(Clamp m) { return fmaxf(m.a, m.b); }

__device__ __forceinline__ Clamp shfl_up(Clamp v, int off) {
  return {__shfl_up_sync(0xffffffffu, v.a, off), __shfl_up_sync(0xffffffffu, v.b, off)};
}
__device__ __forceinline__ Clamp shfl_down(Clamp v, int off) {
  return {__shfl_down_sync(0xffffffffu, v.a, off), __shfl_down_sync(0xffffffffu, v.b, off)};
}

// Exclusive west -> east scan over the block's threads: the composition of
// the maps of threads 0 .. t-1. sh holds the warp totals (kFillWarps).
__device__ Clamp scan_excl_fwd(Clamp v, Clamp* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Clamp u = shfl_up(v, off);
    if (lane >= off) v = compose(u, v);
  }
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    Clamp t = lane < kFillWarps ? sh[lane] : clamp_id();
#pragma unroll
    for (int off = 1; off < kFillWarps; off <<= 1) {
      const Clamp u = shfl_up(t, off);
      if (lane >= off) t = compose(u, t);
    }
    if (lane < kFillWarps) sh[lane] = t;  // inclusive over warps 0 .. lane
  }
  __syncthreads();
  Clamp x = shfl_up(v, 1);
  if (lane == 0) x = clamp_id();
  return warp == 0 ? x : compose(sh[warp - 1], x);
}

// Exclusive east -> west scan: the composition of the maps of threads
// t+1 .. end, the last one applied first.
__device__ Clamp scan_excl_rev(Clamp v, Clamp* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Clamp u = shfl_down(v, off);
    if (lane + off < 32) v = compose(u, v);
  }
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    Clamp t = lane < kFillWarps ? sh[lane] : clamp_id();
#pragma unroll
    for (int off = 1; off < kFillWarps; off <<= 1) {
      const Clamp u = shfl_down(t, off);
      if (lane + off < kFillWarps) t = compose(u, t);
    }
    if (lane < kFillWarps) sh[lane] = t;  // inclusive over warps lane .. end
  }
  __syncthreads();
  Clamp x = shfl_down(v, 1);
  if (lane == 31) x = clamp_id();
  return warp == kFillWarps - 1 ? x : compose(sh[warp + 1], x);
}

// One row of the sweep over the thread's columns [c0, c1). prev is the row
// just finished (nullptr: +inf), cur receives the new row; prev may be cur
// (the staged path): prev is read before the first scan's barrier, cur
// written after it. B is a row of scratch.
__device__ __forceinline__ void row_step(const float* prev, float* cur, float* B,
                                         const float* D, const float* W, const uint8_t* F,
                                         int64_t c0, int64_t c1, int64_t ncol, bool conn8,
                                         Clamp* sh_f, Clamp* sh_r) {
  Clamp agg = clamp_id();
  for (int64_t c = c0; c < c1; ++c) {
    float m = INFINITY;
    if (prev != nullptr) {
      m = prev[c];
      if (conn8) {
        if (c > 0) m = fminf(m, prev[c - 1]);
        if (c + 1 < ncol) m = fminf(m, prev[c + 1]);
      }
    }
    const float b = fminf(W[c], m);
    B[c] = b;
    agg = compose(agg, Clamp{D[c], b});
  }
  float v = at_inf(scan_excl_fwd(agg, sh_f));
  Clamp ragg = clamp_id();
  for (int64_t c = c0; c < c1; ++c) {
    const float d = D[c];
    v = fmaxf(d, fminf(B[c], v));
    cur[c] = v;
    const float b2 = fminf(B[c], v);
    B[c] = b2;
    ragg = compose(Clamp{d, b2}, ragg);  // column c applies before c0 .. c-1
  }
  float v2 = at_inf(scan_excl_rev(ragg, sh_r));
  for (int64_t c = c1 - 1; c >= c0; --c) {
    const float d = D[c];
    v2 = fmaxf(d, fminf(B[c], v2));
    const float o = fmaxf(fminf(cur[c], v2), d);
    cur[c] = F[c] ? W[c] : o;
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kFillThreads)
fill_sweep_kernel(const float* __restrict__ w, const float* __restrict__ d,
                  const uint8_t* __restrict__ f, float* out, float* scratch, int64_t nrow,
                  int64_t ncol, int conn8, int down) {
  __shared__ Clamp sh_f[kFillWarps], sh_r[kFillWarps];
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int64_t K = (ncol + kFillThreads - 1) / kFillThreads;
  const int64_t c0 = tid * K < ncol ? tid * K : ncol;
  const int64_t c1 = c0 + K < ncol ? c0 + K : ncol;
  const bool c8 = conn8 != 0;
  if constexpr (kStaged) {
    // P: the previous row, then the new one; B: b; two buffers of d, w, mask
    float* P = smem;
    float* B = P + ncol;
    float* Ds = B + ncol;
    float* Ws = Ds + 2 * ncol;
    uint8_t* Fs = reinterpret_cast<uint8_t*>(Ws + 2 * ncol);
    const int64_t r0 = down ? 0 : nrow - 1;
    for (int64_t c = tid; c < ncol; c += kFillThreads) {
      P[c] = INFINITY;
      Ds[c] = __ldg(d + r0 * ncol + c);
      Ws[c] = __ldg(w + r0 * ncol + c);
      Fs[c] = __ldg(f + r0 * ncol + c);
    }
    __syncthreads();
    float rd[kStagePer], rw[kStagePer];
    uint8_t rf[kStagePer];
    for (int64_t i = 0; i < nrow; ++i) {
      const int64_t r = down ? i : nrow - 1 - i;
      const int64_t rn = down ? r + 1 : r - 1;
      const int64_t buf = (i & 1) * ncol, nbuf = ncol - buf;
      const bool more = i + 1 < nrow;
      if (more) {  // row r + 1 in flight while row r is scanned
#pragma unroll
        for (int j = 0; j < kStagePer; ++j) {
          const int64_t c = tid + static_cast<int64_t>(j) * kFillThreads;
          if (c < ncol) {
            rd[j] = __ldg(d + rn * ncol + c);
            rw[j] = __ldg(w + rn * ncol + c);
            rf[j] = __ldg(f + rn * ncol + c);
          }
        }
      }
      row_step(P, P, B, Ds + buf, Ws + buf, Fs + buf, c0, c1, ncol, c8, sh_f, sh_r);
      if (more) {  // the other buffer was last read before this row's scans
#pragma unroll
        for (int j = 0; j < kStagePer; ++j) {
          const int64_t c = tid + static_cast<int64_t>(j) * kFillThreads;
          if (c < ncol) {
            Ds[nbuf + c] = rd[j];
            Ws[nbuf + c] = rw[j];
            Fs[nbuf + c] = rf[j];
          }
        }
      }
      __syncthreads();
      for (int64_t c = tid; c < ncol; c += kFillThreads) out[r * ncol + c] = P[c];
    }
  } else {
    for (int64_t i = 0; i < nrow; ++i) {
      const int64_t r = down ? i : nrow - 1 - i;
      const float* prev = i == 0 ? nullptr : out + (down ? r - 1 : r + 1) * ncol;
      row_step(prev, out + r * ncol, scratch, d + r * ncol, w + r * ncol, f + r * ncol, c0,
               c1, ncol, c8, sh_f, sh_r);
      __syncthreads();  // the row is the next one's prev
    }
  }
}

}  // namespace

extern "C" {

// widest row the staged path takes
int pf_fill_stage_cols() { return kStageCols; }

// F1: out = one sweep of (w, d, f), each (nrow, ncol) row-major; scratch
// holds ncol floats and is needed only past pf_fill_stage_cols() columns.
int pf_fill_sweep(const float* w, const float* d, const uint8_t* f, float* out,
                  float* scratch, int64_t nrow, int64_t ncol, int conn8, int down,
                  cudaStream_t stream) {
  if (nrow <= 0 || ncol <= 0) return 0;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t bytes = kStageBytesPerCol * static_cast<size_t>(ncol);
  const bool staged =
      ncol <= kStageCols && bytes + 2 * kFillWarps * sizeof(Clamp) <= static_cast<size_t>(optin);
  if (staged) {
    cudaError_t e = cudaFuncSetAttribute(fill_sweep_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    fill_sweep_kernel<true><<<1, kFillThreads, bytes, stream>>>(w, d, f, out, nullptr, nrow,
                                                               ncol, conn8, down);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    fill_sweep_kernel<false><<<1, kFillThreads, 0, stream>>>(w, d, f, out, scratch, nrow,
                                                            ncol, conn8, down);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
