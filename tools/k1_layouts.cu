// The ELL gather-sum of fedm_tpu_torch/csrc/ell_scatter.cu with the two
// other index layouts its design weighed, for tools/k1_layout_ab.py, which
// times them against the port's kernel on the row-major table as built.
// Not part of the port. Each computes `out[rows[r]] += sum` (or
// `out[r] = sum` without rows), as the port's kernel does:
//
// - staged (ell_staged_*): the row-major table [n_rows, max_val] is staged
//   one [kRows, max_val] tile at a time into shared memory by one bulk
//   asynchronous copy (cp.async.bulk, completed on an mbarrier),
//   double-buffered in a persistent grid of a few blocks per SM, so a
//   block's next tile is in flight while it gathers from the current one.
//   The table must be padded to a whole number of tiles (rows past n_rows
//   are read, never used), so every bulk copy is a multiple of 16 bytes.
// - slot-major (ell_slot_major_*): the table stored as its transpose
//   [max_val, n_rows], so the warp that fills a tile's index rows loads
//   slot v of 32 consecutive rows, 128 contiguous bytes, at a time.
//
// What follows the index load is as in the port's kernel: each tile's
// destinations go to shared memory, then thread (t, c) of the block's
// kRows x C sums component c of row t.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRows = 32;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}\n" ::"r"(bar), "r"(parity) : "memory");
}

template <typename T, int V, int CC>
__global__ void __launch_bounds__(kRows * CC)
    staged_kernel(const int32_t* __restrict__ idx,
                  const int32_t* __restrict__ rows,
                  const T* __restrict__ flat, T* __restrict__ out,
                  int64_t n_rows, int64_t n_flat, int accumulate) {
  constexpr uint32_t kTileBytes = kRows * V * sizeof(int32_t);
  __shared__ __align__(128) int32_t tile[2][kRows * V];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int64_t ds[kRows];
  const int64_t n_tiles = (n_rows + kRows - 1) / kRows;
  const int t = threadIdx.x / CC, c = threadIdx.x - t * CC;

  auto issue = [&](int64_t tile_i, int b) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(&bar[b])), "r"(kTileBytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(tile[b])),
        "l"(idx + tile_i * kRows * V), "r"(kTileBytes),
        "r"(smem_addr(&bar[b]))
        : "memory");
  };

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_addr(&bar[b])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && (int64_t)blockIdx.x < n_tiles) issue(blockIdx.x, 0);

  uint32_t phase[2] = {0, 0};
  int b = 0;
  for (int64_t ti = blockIdx.x; ti < n_tiles; ti += gridDim.x, b ^= 1) {
    const int64_t next = ti + gridDim.x;
    if (threadIdx.x == 0 && next < n_tiles) issue(next, b ^ 1);
    const int64_t base = ti * kRows;
    if (threadIdx.x < kRows && base + threadIdx.x < n_rows)
      ds[threadIdx.x] = rows ? (int64_t)__ldg(rows + base + threadIdx.x)
                             : base + threadIdx.x;
    wait_parity(smem_addr(&bar[b]), phase[b]);
    phase[b] ^= 1;
    __syncthreads();
    if (base + t < n_rows) {
      T* dst = out + ds[t] * CC + c;
      const T prev = accumulate ? *dst : T(0);
      T x[V];
      bool ok[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int32_t j = tile[b][t * V + v];
        ok[v] = j >= 0 && j < n_flat;
        x[v] = T(0);
        if (ok[v]) x[v] = __ldg(flat + (int64_t)j * CC + c);
      }
      T acc = T(0);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (ok[v]) acc += x[v];
      }
      *dst = accumulate ? prev + acc : acc;
    }
    __syncthreads();  // tile[b] is refilled two tiles on, ds next tile
  }
}

// The port's tiled kernel, reading slot v of row r at idx[v * n_rows + r].
template <typename T, int V, int CC>
__global__ void __launch_bounds__(kRows * CC)
    slot_major_kernel(const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ rows,
                      const T* __restrict__ flat, T* __restrict__ out,
                      int64_t n_rows, int64_t n_flat, int accumulate) {
  __shared__ int32_t js[kRows][V];
  __shared__ int64_t ds[kRows];
  const int t = threadIdx.x / CC, c = threadIdx.x - t * CC;
  for (int64_t base = (int64_t)blockIdx.x * kRows; base < n_rows;
       base += (int64_t)gridDim.x * kRows) {
    if (threadIdx.x < kRows && base + threadIdx.x < n_rows) {
      const int64_t r = base + threadIdx.x;
      ds[threadIdx.x] = rows ? (int64_t)__ldg(rows + r) : r;
#pragma unroll
      for (int v = 0; v < V; ++v)
        js[threadIdx.x][v] = __ldg(idx + v * n_rows + r);
    }
    __syncthreads();
    if (base + t < n_rows) {
      T* dst = out + ds[t] * CC + c;
      const T prev = accumulate ? *dst : T(0);
      T x[V];
      bool ok[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int32_t j = js[t][v];
        ok[v] = j >= 0 && j < n_flat;
        x[v] = T(0);
        if (ok[v]) x[v] = __ldg(flat + (int64_t)j * CC + c);
      }
      T acc = T(0);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (ok[v]) acc += x[v];
      }
      *dst = accumulate ? prev + acc : acc;
    }
    __syncthreads();
  }
}

template <typename T, int V, int CC>
int run(bool slot_major, const void* idx, const void* rows,
        const void* flat, void* out, long long n_rows, long long n_flat,
        int accumulate, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  const long long n_tiles = (n_rows + kRows - 1) / kRows;
  if (slot_major) {  // the port's grid: one block per tile
    slot_major_kernel<T, V, CC><<<(unsigned)n_tiles, kRows * CC, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(idx), static_cast<const int32_t*>(rows),
        static_cast<const T*>(flat), static_cast<T*>(out), n_rows, n_flat,
        accumulate);
    return (int)cudaGetLastError();
  }
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long grid =
      n_tiles < (long long)sms * kBlocksPerSm ? n_tiles
                                              : (long long)sms * kBlocksPerSm;
  staged_kernel<T, V, CC><<<(unsigned)grid, kRows * CC, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(rows),
      static_cast<const T*>(flat), static_cast<T*>(out), n_rows, n_flat,
      accumulate);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(bool slot_major, const void* idx, const void* rows,
             const void* flat, void* out, long long n_rows, int max_val,
             long long n_flat, int C, void* stream) {
  const int acc = rows != nullptr;
#define K1_CASE(V_, C_)                                                      \
  if (max_val == V_ && C == C_)                                              \
    return run<T, V_, C_>(slot_major, idx, rows, flat, out, n_rows, n_flat, \
                          acc, stream);
  K1_CASE(2, 3)
  K1_CASE(2, 9)
  K1_CASE(6, 3)
#undef K1_CASE
  return (int)cudaErrorInvalidValue;  // the shapes the timing script uses
}

}  // namespace

// rows: null for the dense form (out = sum), else the live rows (out +=
// sum). Staged: idx row-major [ceil(n_rows / 32) * 32, max_val] int32.
// Slot-major: idx [max_val, n_rows] int32.
#define K1_ENTRY_POINTS(T, SUFFIX)                                           \
  extern "C" int ell_staged_##SUFFIX(                                        \
      const void* idx, const void* rows, const void* flat, void* out,        \
      long long n_rows, int max_val, long long n_flat, int C,                \
      void* stream) {                                                        \
    return dispatch<T>(false, idx, rows, flat, out, n_rows, max_val, n_flat, \
                       C, stream);                                           \
  }                                                                          \
  extern "C" int ell_slot_major_##SUFFIX(                                    \
      const void* idx, const void* rows, const void* flat, void* out,        \
      long long n_rows, int max_val, long long n_flat, int C,                \
      void* stream) {                                                        \
    return dispatch<T>(true, idx, rows, flat, out, n_rows, max_val, n_flat,  \
                       C, stream);                                           \
  }

K1_ENTRY_POINTS(float, f32)
K1_ENTRY_POINTS(double, f64)
