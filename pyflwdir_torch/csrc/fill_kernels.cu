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
// min/max a cell. Neither binds: each row needs the whole row before it
// (the east -> west scan ends at column 0), so a sweep is a chain of nrow
// dependent row steps, and its time is nrow times the latency of one step
// on one SM. Rows and strips cannot be split across blocks: that would
// change the Gauss-Seidel order, the sweep's output and the round count.
//
// Design: one block runs the sweep and cuts the row step's latency.
// * Columns in registers. Thread t owns the K contiguous columns
//   [t K, t K + K): 256 threads up to 1,536 columns (K <= 6), 512 up to
//   8,192 (K = 4 .. 16; 12 at the 6,000-column tile). Fewer threads than
//   the row's width allows cut the scans' share of the instructions, which
//   every warp issues once a row whatever its K; these two widths came out
//   fastest at 682, 1,536, 4,096 and 6,000 columns. The row's d, w, mask,
//   b and forward values and the previous row's output stay in registers
//   (K a template parameter), so the three column walks touch no shared
//   memory. A thread reads its run from the staged row as float4 / float2
//   vectors where K allows (bank-conflict free for K = 12 and the odd K)
//   and writes its output run the same way.
// * The previous row's halo from the neighbour: prev[c0 - 1] and prev[c1]
//   come by __shfl_up / __shfl_down of the neighbour lane's end values;
//   only the warp-edge values go through shared memory.
// * Three barriers a row: one that publishes the previous row (its output
//   run and warp edges), and one in each block scan. A scan is a warp
//   shuffle scan of the (a, b) pairs; the warp totals go through shared
//   memory, and after the barrier every warp scans them itself instead of
//   waiting for one warp and a second barrier. A clamp map composed with
//   itself is itself, so no shuffle round needs a lane predicate.
// * Rows ahead by the Tensor Memory Accelerator: thread 0 issues 1-D bulk
//   copies (cp.async.bulk with an mbarrier that expects the bytes) of d, w
//   and the mask of row i + S - 1 into a ring of S = 2..4 stages (9 bytes a
//   column, 54 KB a 6,000-column row) while row i is computed. A finished
//   row goes from a double-buffered output row in shared memory to device
//   memory by a bulk store (after fence.proxy.async), off the chain.
//   Arrays whose rows are not 16-byte aligned (ncol % 4 != 0 for floats,
//   ncol % 16 != 0 for the mask, or a base pointer off 16 bytes) take other
//   loads inside the same kernel: cp.async of 4 bytes an element for d and
//   w, a register prefetch of one row ahead for the mask, and coalesced
//   stores of the output row from shared memory.
// * Rows wider than 8,192 columns take a chunked path: 1,024 threads, the
//   row in chunks of 8,192 columns, 8 a thread, each scan's chunk
//   aggregates composed in order, the forward values and b in device memory
//   between the two passes (the output row and a scratch row).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRegCols = 8192;   // the widest row the one-chunk kernel takes
constexpr int kSmallCols = 1536;  // up to here 256 threads (K <= 6), past it 512
constexpr int kWideThreads = 1024, kWideK = 8;  // the chunked kernel: 8,192 columns a chunk
constexpr int kMaxStages = 4;
constexpr unsigned kFull = 0xffffffffu;

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
  return {__shfl_up_sync(kFull, v.a, off), __shfl_up_sync(kFull, v.b, off)};
}
__device__ __forceinline__ Clamp shfl_down(Clamp v, int off) {
  return {__shfl_down_sync(kFull, v.a, off), __shfl_down_sync(kFull, v.b, off)};
}
__device__ __forceinline__ Clamp shfl_idx(Clamp v, int lane) {
  return {__shfl_sync(kFull, v.a, lane), __shfl_sync(kFull, v.b, lane)};
}

// Exclusive west -> east scan over the block's NW warps, one barrier: the
// composition of the maps of threads 0 .. t-1; with kTotal, *total gets the
// whole block's. A clamp map composed with itself is itself, so the lanes
// that __shfl_up leaves with their own value need no predicate. tot holds
// NW Clamps and is not written again before the next barrier.
template <int NW, bool kTotal>
__device__ __forceinline__ Clamp scan_fwd(Clamp v, Clamp* tot, Clamp* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) v = compose(shfl_up(v, off), v);
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  Clamp t = lane < NW ? tot[lane] : clamp_id();  // every warp scans the totals itself
#pragma unroll
  for (int off = 1; off < NW; off <<= 1) t = compose(shfl_up(t, off), t);
  const Clamp wpre = shfl_idx(t, (warp + 31) & 31);  // over warps 0 .. warp-1
  if constexpr (kTotal) *total = shfl_idx(t, NW - 1);
  Clamp x = shfl_up(v, 1);
  if (lane == 0) x = clamp_id();
  return warp == 0 ? x : compose(wpre, x);
}

// Exclusive east -> west scan: the composition of the maps of threads
// t+1 .. the last, the last one applied first.
template <int NW, bool kTotal>
__device__ __forceinline__ Clamp scan_rev(Clamp v, Clamp* tot, Clamp* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) v = compose(shfl_down(v, off), v);
  if (lane == 0) tot[warp] = v;
  __syncthreads();
  Clamp t = lane < NW ? tot[lane] : clamp_id();
#pragma unroll
  for (int off = 1; off < NW; off <<= 1) t = compose(shfl_down(t, off), t);
  const Clamp wpre = shfl_idx(t, (warp + 1) & 31);  // over warps warp+1 .. NW-1
  if constexpr (kTotal) *total = shfl_idx(t, 0);
  Clamp x = shfl_down(v, 1);
  if (lane == 31) x = clamp_id();
  return warp == NW - 1 ? x : compose(wpre, x);
}

// ---------------------------------------------------------------------------
// The register row step, shared by both kernels. Thread t's K columns
// start at c0; columns at or past ncol are padding: identity maps, output
// +inf. p holds the previous row's values (+inf before the first row) and
// receives the new ones; hl / hr are prev[c0 - 1] and prev[c0 + K].
// The one-chunk kernel passes no carry (kChunked false); the chunked one
// walks chunks in order and passes the carry in and out.
// ---------------------------------------------------------------------------
template <int K>
__device__ __forceinline__ void row_b(const float (&p)[K], float hl, float hr,
                                      const float (&w)[K], bool conn8, float (&b)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float m = p[j];
    if (conn8) {
      m = fminf(fminf(j > 0 ? p[j - 1] : hl, m), j + 1 < K ? p[j + 1] : hr);
    }
    b[j] = fminf(w[j], m);
  }
}

// Forward half: from b, the clamp scan west -> east; returns with fwd and
// b2 = min(b, fwd) in place of b. kChunked: the chunks west of this one
// apply first (*carry) and this chunk's total is composed onto *carry.
template <int NW, int K, bool kChunked>
__device__ __forceinline__ void row_fwd(const float (&d)[K], float (&b)[K], float (&fwd)[K],
                                        int nvalid, Clamp* tot, Clamp* carry) {
  Clamp agg = clamp_id();
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < nvalid) agg = compose(agg, Clamp{d[j], b[j]});
  }
  Clamp total;
  const Clamp excl = scan_fwd<NW, kChunked>(agg, tot, &total);
  float v = at_inf(kChunked ? compose(*carry, excl) : excl);
  if constexpr (kChunked) *carry = compose(*carry, total);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    v = fmaxf(d[j], fminf(b[j], v));
    fwd[j] = v;
    b[j] = fminf(b[j], v);
  }
}

// Reverse half: the clamp scan east -> west over (d, b2); out = the row's
// new values (fixed cells keep w, padding +inf).
template <int NW, int K, bool kChunked>
__device__ __forceinline__ void row_rev(const float (&d)[K], const float (&b2)[K],
                                        const float (&fwd)[K], const float (&w)[K],
                                        uint32_t fix, int nvalid, Clamp* tot, Clamp* carry,
                                        float (&out)[K]) {
  Clamp ragg = clamp_id();
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < nvalid) ragg = compose(Clamp{d[j], b2[j]}, ragg);  // column j before j-1 .. 0
  }
  Clamp total;
  const Clamp excl = scan_rev<NW, kChunked>(ragg, tot, &total);
  float v = at_inf(kChunked ? compose(*carry, excl) : excl);
  if constexpr (kChunked) *carry = compose(*carry, total);
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    if (j < nvalid) {  // padding east of the run passes v through
      v = fmaxf(d[j], fminf(b2[j], v));
      out[j] = (fix >> j) & 1u ? w[j] : fmaxf(fminf(fwd[j], v), d[j]);
    } else {
      out[j] = INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// Shared-memory vectors of a thread's K-column run.
// ---------------------------------------------------------------------------
template <int K>
__device__ __forceinline__ void lds_run(const float* s, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(s)[q];
      v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z, v[4 * q + 3] = x.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int q = 0; q < K / 2; ++q) {
      const float2 x = reinterpret_cast<const float2*>(s)[q];
      v[2 * q] = x.x, v[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = s[j];
  }
}

template <int K>
__device__ __forceinline__ void sts_run(float* s, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      reinterpret_cast<float4*>(s)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int q = 0; q < K / 2; ++q) {
      reinterpret_cast<float2*>(s)[q] = make_float2(v[2 * q], v[2 * q + 1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) s[j] = v[j];
  }
}

// the run's mask bytes as bits (bit j: column j fixed)
template <int K>
__device__ __forceinline__ uint32_t lds_mask(const uint8_t* s) {
  uint32_t bits = 0;
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const uint32_t x = reinterpret_cast<const uint32_t*>(s)[q];
#pragma unroll
      for (int k = 0; k < 4; ++k) bits |= (((x >> (8 * k)) & 0xffu) != 0u) << (4 * q + k);
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) bits |= (s[j] != 0) << j;
  }
  return bits;
}

// ---------------------------------------------------------------------------
// Hopper asynchronous copies: mbarriers, 1-D bulk copies, cp.async.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) global -> shared
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bytes shared -> global, tracked by the issuing thread's bulk groups
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read_1() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// generic-proxy shared-memory accesses before async-proxy ones
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most n of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 2;" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// The one-chunk kernel (ncol <= 8,192).
// Shared memory: S stages of [d: P floats | w: P floats | mask: P bytes],
// two output rows of P floats, S mbarriers; P = kThreads K (padding unread
// but for the ignored tail of the last runs). Static: warp totals, edges.
// ---------------------------------------------------------------------------
struct Modes {
  int tma_f;    // d and w rows by bulk copy (else cp.async)
  int tma_m;    // mask rows by bulk copy (else a register prefetch)
  int tma_out;  // output rows by bulk store (else coalesced stores)
};

template <int kThreads, int K>
__global__ void __launch_bounds__(kThreads, 1)
fill_sweep_kernel(const float* __restrict__ w, const float* __restrict__ d,
                  const uint8_t* __restrict__ f, float* __restrict__ out, int nrow, int ncol,
                  int conn8, int down, int S, Modes md) {
  constexpr int P = kThreads * K;
  constexpr size_t kStage = 9 * static_cast<size_t>(P);
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int kWarps = kThreads / 32;
  __shared__ Clamp tot_f[kWarps], tot_r[kWarps];
  __shared__ float edge_l[kWarps], edge_r[kWarps];
  float* outbuf = reinterpret_cast<float*>(smem + S * kStage);
  uint64_t* bar = reinterpret_cast<uint64_t*>(outbuf + 2 * P);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = tid * K;
  const int nvalid = c0 >= ncol ? 0 : (ncol - c0 < K ? ncol - c0 : K);
  const bool c8 = conn8 != 0;
  const bool tma_in = md.tma_f || md.tma_m;
  const uint32_t tx = (md.tma_f ? 8u * ncol : 0u) + (md.tma_m ? static_cast<uint32_t>(ncol) : 0u);
  auto row_of = [&](int i) { return static_cast<int64_t>(down ? i : nrow - 1 - i); };
  auto sd = [&](int s) { return reinterpret_cast<float*>(smem + s * kStage); };
  auto sw = [&](int s) { return sd(s) + P; };
  auto sf = [&](int s) { return reinterpret_cast<uint8_t*>(sd(s) + 2 * P); };

  // rows ahead: bulk copies (thread 0) and cp.async (every thread)
  auto issue = [&](int i) {
    const int s = i % S;
    const int64_t r = row_of(i);
    if (tid == 0 && tma_in) {
      fence_proxy_async();
      mbar_expect_tx(&bar[s], tx);
      if (md.tma_f) {
        bulk_load(sd(s), d + r * ncol, 4u * ncol, &bar[s]);
        bulk_load(sw(s), w + r * ncol, 4u * ncol, &bar[s]);
      }
      if (md.tma_m) bulk_load(sf(s), f + r * ncol, static_cast<uint32_t>(ncol), &bar[s]);
    }
    if (!md.tma_f) {
      for (int c = tid; c < ncol; c += kThreads) {
        cp_async4(sd(s) + c, d + r * ncol + c);
        cp_async4(sw(s) + c, w + r * ncol + c);
      }
    }
  };
  // the register prefetch of an unaligned mask row: column tid + kThreads j
  // in byte j (ncol <= kThreads K)
  constexpr int kMaskWords = (K + 3) / 4;
  auto load_mask = [&](int i, uint32_t (&m)[kMaskWords]) {
    const int64_t r = row_of(i);
#pragma unroll
    for (int q = 0; q < kMaskWords; ++q) m[q] = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = tid + j * kThreads;
      if (c < ncol) m[j >> 2] |= static_cast<uint32_t>(__ldg(f + r * ncol + c)) << (8 * (j & 3));
    }
  };
  auto store_mask = [&](int i, const uint32_t (&m)[kMaskWords]) {
    uint8_t* s = sf(i % S);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = tid + j * kThreads;
      if (c < ncol) s[c] = static_cast<uint8_t>(m[j >> 2] >> (8 * (j & 3)));
    }
  };
  // the finished row i from outbuf[i % 2] to device memory
  auto flush = [&](int i) {
    const float* ob = outbuf + (i & 1) * P;
    float* dst = out + row_of(i) * ncol;
    if (md.tma_out) {
      if (tid == 0) bulk_store(dst, ob, 4u * ncol);
    } else {
      for (int c = tid; c < ncol; c += kThreads) dst[c] = ob[c];
    }
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < kWarps) edge_l[tid] = edge_r[tid] = INFINITY;
  __syncthreads();
  uint32_t mpre[kMaskWords];
  for (int i = 0; i < S - 1; ++i) {
    if (i < nrow) issue(i);
    if (!md.tma_f) cp_async_commit();
  }
  if (!md.tma_m) {
    load_mask(0, mpre);
    store_mask(0, mpre);
  }
  if (!md.tma_f) cp_async_wait(S - 2);

  float p[K];
#pragma unroll
  for (int j = 0; j < K; ++j) p[j] = INFINITY;

  for (int i = 0; i < nrow; ++i) {
    __syncthreads();  // (1) the previous row's output run, edges and staged loads
    if (i > 0) flush(i - 1);
    if (i + S - 1 < nrow) issue(i + S - 1);
    if (!md.tma_f) cp_async_commit();
    if (!md.tma_m && i + 1 < nrow) load_mask(i + 1, mpre);
    if (tid == 0 && md.tma_out) bulk_wait_read_1();  // outbuf[i % 2] free again
    const int s = i % S;
    if (tma_in) mbar_wait(&bar[s], (i / S) & 1);

    float dv[K], wv[K], b[K], fwd[K];
    lds_run<K>(sd(s) + c0, dv);
    lds_run<K>(sw(s) + c0, wv);
    const uint32_t fix = lds_mask<K>(sf(s) + c0);
    float hl = __shfl_up_sync(kFull, p[K - 1], 1);
    float hr = __shfl_down_sync(kFull, p[0], 1);
    if (lane == 0) hl = warp > 0 ? edge_r[warp - 1] : INFINITY;
    if (lane == 31) hr = warp < kWarps - 1 ? edge_l[warp + 1] : INFINITY;
    row_b<K>(p, hl, hr, wv, c8, b);
    row_fwd<kWarps, K, false>(dv, b, fwd, nvalid, tot_f, nullptr);       // (2)
    row_rev<kWarps, K, false>(dv, b, fwd, wv, fix, nvalid, tot_r, nullptr, p);  // (3)

    sts_run<K>(outbuf + (i & 1) * P + c0, p);
    if (lane == 31) edge_r[warp] = p[K - 1];
    if (lane == 0) edge_l[warp] = p[0];
    if (md.tma_out) fence_proxy_async();
    if (!md.tma_m && i + 1 < nrow) store_mask(i + 1, mpre);
    if (!md.tma_f) cp_async_wait(S - 2);
  }
  __syncthreads();
  flush(nrow - 1);
  if (tid == 0 && md.tma_out) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// The chunked kernel (ncol > 8,192): chunks of 8,192 columns, 8 a thread,
// in order; the forward values wait in the output row and b2 in a scratch
// row between the two passes, each read back by the thread that wrote it.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kWideThreads, 1)
fill_sweep_wide_kernel(const float* __restrict__ w, const float* __restrict__ d,
                       const uint8_t* __restrict__ f, float* out, float* scratch, int nrow,
                       int ncol, int conn8, int down) {
  constexpr int K = kWideK, kWarps = kWideThreads / 32;
  __shared__ Clamp tot[2][kWarps];  // alternate scans: no barrier between two uses
  const int tid = threadIdx.x;
  const int nch = (ncol + kRegCols - 1) / kRegCols;
  const bool c8 = conn8 != 0;
  int nscan = 0;
  for (int i = 0; i < nrow; ++i) {
    const int64_t r = down ? i : nrow - 1 - i;
    const float* prev = i == 0 ? nullptr : out + (down ? r - 1 : r + 1) * ncol;
    float* cur = out + r * ncol;
    auto at = [&](const float* row, int c) {
      return row != nullptr && c >= 0 && c < ncol ? row[c] : INFINITY;
    };
    Clamp carry = clamp_id();
    for (int ch = 0; ch < nch; ++ch) {
      const int c0 = ch * kRegCols + tid * K;
      const int nvalid = c0 >= ncol ? 0 : (ncol - c0 < K ? ncol - c0 : K);
      float p[K], dv[K], wv[K], b[K], fwd[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool ok = j < nvalid;
        p[j] = at(prev, ok ? c0 + j : -1);
        dv[j] = ok ? __ldg(d + r * ncol + c0 + j) : INFINITY;
        wv[j] = ok ? __ldg(w + r * ncol + c0 + j) : INFINITY;
      }
      row_b<K>(p, at(prev, c0 - 1), at(prev, c0 + K), wv, c8, b);
      row_fwd<kWarps, K, true>(dv, b, fwd, nvalid, tot[nscan++ & 1], &carry);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (j < nvalid) {
          cur[c0 + j] = fwd[j];
          scratch[c0 + j] = b[j];
        }
      }
    }
    carry = clamp_id();
    for (int ch = nch - 1; ch >= 0; --ch) {
      const int c0 = ch * kRegCols + tid * K;
      const int nvalid = c0 >= ncol ? 0 : (ncol - c0 < K ? ncol - c0 : K);
      float dv[K], wv[K], b2[K], fwd[K], o[K];
      uint32_t fix = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool ok = j < nvalid;
        dv[j] = ok ? __ldg(d + r * ncol + c0 + j) : INFINITY;
        wv[j] = ok ? __ldg(w + r * ncol + c0 + j) : INFINITY;
        b2[j] = ok ? scratch[c0 + j] : INFINITY;
        fwd[j] = ok ? cur[c0 + j] : INFINITY;
        fix |= static_cast<uint32_t>(ok && __ldg(f + r * ncol + c0 + j) != 0) << j;
      }
      row_rev<kWarps, K, true>(dv, b2, fwd, wv, fix, nvalid, tot[nscan++ & 1], &carry, o);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (j < nvalid) cur[c0 + j] = o[j];
      }
    }
    __syncthreads();  // the row is the next one's prev
  }
}

template <int kThreads, int K>
int launch_one_chunk(const float* w, const float* d, const uint8_t* f, float* out, int nrow,
                     int ncol, int conn8, int down, cudaStream_t stream) {
  constexpr size_t P = static_cast<size_t>(kThreads) * K;
  static int optin = -1;
  if (optin < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  // static shared memory: warp totals and edges (1 KB); output rows and
  // mbarriers beside the stages
  const size_t fixed = 2 * P * sizeof(float) + kMaxStages * sizeof(uint64_t) + 1024;
  int S = static_cast<int>((static_cast<size_t>(optin) - fixed) / (9 * P));
  S = S > kMaxStages ? kMaxStages : S;
  if (S < 2) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t bytes = S * 9 * P + 2 * P * sizeof(float) + S * sizeof(uint64_t);
  cudaError_t e = cudaFuncSetAttribute(fill_sweep_kernel<kThreads, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  auto al16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  Modes md;
  md.tma_f = al16(w) && al16(d) && ncol % 4 == 0;
  md.tma_m = al16(f) && ncol % 16 == 0;
  md.tma_out = al16(out) && ncol % 4 == 0;
  fill_sweep_kernel<kThreads, K><<<1, kThreads, bytes, stream>>>(w, d, f, out, nrow, ncol,
                                                                 conn8, down, S, md);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// widest row the one-chunk kernel takes; wider rows are chunked
int pf_fill_stage_cols() { return kRegCols; }

// F1: out = one sweep of (w, d, f), each (nrow, ncol) row-major, fewer than
// 2^31 cells; scratch holds ncol floats and is needed only past
// pf_fill_stage_cols() columns.
int pf_fill_sweep(const float* w, const float* d, const uint8_t* f, float* out,
                  float* scratch, int64_t nrow, int64_t ncol, int conn8, int down,
                  cudaStream_t stream) {
  if (nrow <= 0 || ncol <= 0) return 0;
  if (nrow * ncol >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int R = static_cast<int>(nrow), C = static_cast<int>(ncol);
#define PF_FILL_CASE(NT, K) \
  case K: return launch_one_chunk<NT, K>(w, d, f, out, R, C, conn8, down, stream);
  if (C <= kSmallCols) {
    switch ((C + 255) / 256) {
      PF_FILL_CASE(256, 1) PF_FILL_CASE(256, 2) PF_FILL_CASE(256, 3)
      PF_FILL_CASE(256, 4) PF_FILL_CASE(256, 5) PF_FILL_CASE(256, 6)
    }
  } else if (C <= kRegCols) {
    switch ((C + 511) / 512) {
      PF_FILL_CASE(512, 4) PF_FILL_CASE(512, 5) PF_FILL_CASE(512, 6)
      PF_FILL_CASE(512, 7) PF_FILL_CASE(512, 8) PF_FILL_CASE(512, 9)
      PF_FILL_CASE(512, 10) PF_FILL_CASE(512, 11) PF_FILL_CASE(512, 12)
      PF_FILL_CASE(512, 13) PF_FILL_CASE(512, 14) PF_FILL_CASE(512, 15)
      PF_FILL_CASE(512, 16)
    }
  }
#undef PF_FILL_CASE
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  fill_sweep_wide_kernel<<<1, kWideThreads, 0, stream>>>(w, d, f, out, scratch, R, C, conn8,
                                                         down);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
