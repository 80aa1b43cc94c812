// Candidate geometries of kernel H1 (accel_in_scan) for tools/bench_h1_geometry.py:
// threads, slots a thread, window tiles a lane (W = 32 K) and blocks an SM
// the registers must leave room for. Includes the kernel source itself.
#include "../pyflwdir_torch/csrc/accel_kernels.cu"

namespace {
template <typename T, int NT, int PER, int K, int MINB = 1>
int launch_v(const void* x, int64_t n_x, const int32_t* src, void* c, int64_t n,
             void* scratch, cudaStream_t s) {
  constexpr int64_t tile = NT * PER;
  const int64_t n_tiles = (n + tile - 1) / tile;
  ulonglong2* agg = static_cast<ulonglong2*>(scratch);
  cudaMemsetAsync(scratch, 0, scan_scratch_bytes(n_tiles), s);
  in_scan_kernel<T, NT, PER, K, MINB><<<static_cast<unsigned>(n_tiles), NT, 0, s>>>(
      static_cast<const T*>(x), n_x, src, static_cast<T*>(c), n, agg, agg + n_tiles,
      reinterpret_cast<int*>(agg + 2 * n_tiles));
  return static_cast<int>(cudaGetLastError());
}
template <typename T>
int by_variant4(int v, const void* x, int64_t n_x, const int32_t* src, void* c, int64_t n,
                void* scratch, cudaStream_t s) {
  switch (v) {
    case 0: return launch_v<T, 512, 16, 2>(x, n_x, src, c, n, scratch, s);
    case 1: return launch_v<T, 512, 16, 1>(x, n_x, src, c, n, scratch, s);
    case 2: return launch_v<T, 512, 16, 4>(x, n_x, src, c, n, scratch, s);
    case 3: return launch_v<T, 256, 16, 2>(x, n_x, src, c, n, scratch, s);
    case 4: return launch_v<T, 512, 8, 2>(x, n_x, src, c, n, scratch, s);
    case 5: return launch_v<T, 256, 32, 2>(x, n_x, src, c, n, scratch, s);
    case 6: return launch_v<T, 256, 16, 4>(x, n_x, src, c, n, scratch, s);
    case 7: return launch_v<T, 512, 16, 2, 2>(x, n_x, src, c, n, scratch, s);
    case 8: return launch_v<T, 512, 8, 4>(x, n_x, src, c, n, scratch, s);
    case 9: return launch_v<T, 256, 8, 4>(x, n_x, src, c, n, scratch, s);
    case 10: return launch_v<T, 512, 8, 2, 3>(x, n_x, src, c, n, scratch, s);
    case 11: return launch_v<T, 512, 16, 8>(x, n_x, src, c, n, scratch, s);
    default: return -1;
  }
}
template <typename T>
int by_variant8(int v, const void* x, int64_t n_x, const int32_t* src, void* c, int64_t n,
                void* scratch, cudaStream_t s) {
  switch (v) {
    case 0: return launch_v<T, 512, 8, 2>(x, n_x, src, c, n, scratch, s);
    case 1: return launch_v<T, 512, 8, 1>(x, n_x, src, c, n, scratch, s);
    case 2: return launch_v<T, 512, 8, 4>(x, n_x, src, c, n, scratch, s);
    case 3: return launch_v<T, 256, 8, 2>(x, n_x, src, c, n, scratch, s);
    case 4: return launch_v<T, 256, 16, 2>(x, n_x, src, c, n, scratch, s);
    case 5: return launch_v<T, 512, 4, 4>(x, n_x, src, c, n, scratch, s);
    case 6: return launch_v<T, 256, 16, 4>(x, n_x, src, c, n, scratch, s);
    case 7: return launch_v<T, 512, 8, 2, 2>(x, n_x, src, c, n, scratch, s);
    case 8: return launch_v<T, 512, 8, 8>(x, n_x, src, c, n, scratch, s);
    case 9: return launch_v<T, 256, 8, 4>(x, n_x, src, c, n, scratch, s);
    case 10: return launch_v<T, 512, 8, 2, 3>(x, n_x, src, c, n, scratch, s);
    case 11: return launch_v<T, 256, 16, 8>(x, n_x, src, c, n, scratch, s);
    default: return -1;
  }
}
}  // namespace

extern "C" int hv_in_scan(int v, int dt, const void* x, int64_t n_x, const int32_t* src,
                          void* c, int64_t n, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dt) {
    case 0: return by_variant4<float>(v, x, n_x, src, c, n, scratch, s);
    case 1: return by_variant4<int32_t>(v, x, n_x, src, c, n, scratch, s);
    case 2: return by_variant8<int64_t>(v, x, n_x, src, c, n, scratch, s);
    case 3: return by_variant8<double>(v, x, n_x, src, c, n, scratch, s);
    default: return -1;
  }
}
