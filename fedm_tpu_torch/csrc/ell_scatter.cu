// ELL gather-sum for Hopper (sm_90a). One templated kernel serves two
// functions:
//   dense   ell_scatter:      out[d, :]        = sum_v flat[idx[d, v], :]
//                             for every destination row d;
//   compact ell_scatter_add:  out[rows[r], :] += sum_v flat[idx[r, v], :]
//                             for the live rows r only, in place.
// Any index outside [0, n_flat) (the padding sentinel) contributes zero.
//
// Replaces the TPU kernel fedm_tpu/ops/pallas_scatter.py:_ell_kernel
// (pallas_ell_scatter), which tiled 512 dofs per grid step, handled one
// trailing component per call and read pad entries from a sentinel zero row
// appended to `flat`. Here the trailing axis is fused (the wrapper flattens
// it to one width C) and no sentinel row is concatenated onto `flat`.
//
// What bounds it. Each output element costs max_val index reads and up to
// max_val gathered reads for one add each: well under one operation per
// byte, so never the card's arithmetic. At the full-mesh shape (161,385
// rows x 6 slots, ~17 MB) it is bytes: idx + flat + out over 3.35 TB/s. At
// the main path's electrode-facet shape the compact table has 578 live rows
// x 2 slots and the call moves ~31 KB (f32, C = 3), ~9 ns of HBM time, so
// there it is latency: launch, then two dependent memory round trips
// (rows + idx, then the gathered rows of flat + the rows of out), then the
// store.
// The floor of such a call is the device time of an empty kernel
// (`ell_noop`, timed beside it by chip_smoke.py).
//
// What the design does about that:
// - Compaction. The facet's table lists only the rows that receive a
//   contribution, and the kernel adds straight into the caller's residual:
//   one launch, where a dense table needs a [n_dofs, C] pass and then a
//   second full-size add. `rows` has no duplicates, so no atomics, and the
//   result is deterministic: each row's sum starts from zero, adds the slots
//   in order v = 0..max_val-1 and only then is added to out, the summation
//   order of `out + dense scatter`.
// - Each row's index row is read once. A block of 32 x C threads walks
//   tiles of 32 rows: one warp reads the tile's destinations and index
//   rows into shared memory, then thread (t, c) sums component c of row t.
//   Consecutive threads read the C components of a gathered row of flat,
//   and write those of a row of out, together (a dense tile's out is one
//   contiguous span), and a latency-bound call spreads over as many SMs as
//   it has tiles. Two earlier designs were measured and dropped (PERF.md):
//   one thread per row for the whole call, whose C-strided loads and
//   stores touch a separate sector per lane and component (20.9 against
//   the replaced kernel's 9.7 us at the dense facet shape in float64,
//   C = 9), and tiles of 128 rows with C components per thread, too few
//   blocks for the 578-row facet call (3.4 against index_add_'s 2.5 us at
//   C = 9).
// - max_val (1, 2, 4, 6, 8) and C (1, 3, 9) are template parameters; each
//   thread issues its out load and all its max_val gathered loads before
//   its first add: loads in flight are what hide latency. Any other
//   max_val or C takes one generic kernel, one thread per (row,
//   component), that reads the index row from global memory.
// - Index layout: the table is row-major [n_rows, max_val], as the
//   batches build and keep it, so the warp that reads a tile's index rows
//   reads one contiguous span of 32 x max_val int32. Two other layouts
//   were timed against it in one chip run of tools/k1_layout_ab.py
//   (PERF.md; their kernels are in tools/k1_layouts.cu): the transpose
//   [max_val, n_rows] (each slot's load 128 contiguous bytes) was within
//   2 % at the facet calls and 2-4 % slower at the full-mesh shape;
//   staging row-major tiles into shared memory with cp.async.bulk on an
//   mbarrier, double-buffered in a persistent grid, was 6-18 % slower
//   everywhere.
// - Gathered loads, index loads and rows go through the read-only path
//   (__ldg, ld.global.nc); out is a plain read-modify-write. Each thread
//   moves one component, so no vector loads (in f32 with C = 3 a row is
//   12 bytes, not 16-byte aligned, in any case).
// - Not applicable: there is no matrix product, so tensor cores play no
//   part; Hopper's TMA has no gather mode, so it could fetch only the
//   contiguous index tiles (the staged variant), never the gathered
//   rows of flat.
//
// The plain C interface (raw pointers, sizes, a stream) keeps
// PyTorch's headers out, so nvcc builds this file in seconds.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // threads per block of the generic kernel
constexpr int kRows = 32;      // destination rows per tile

template <typename T>
struct Args {
  const int32_t* idx;   // [n_rows, max_val], row-major
  const int32_t* rows;  // null: row r is destination r
  const T* flat;
  T* out;
  int64_t n_rows, n_flat;
  int max_val, C;
  int accumulate;              // out += sum (else out = sum)
};

// max_val = V and C = CC known at compile time. A block of kRows x CC
// threads walks tiles of kRows rows: the first kRows threads read one
// row's destination and index row each into shared memory; then thread
// (t, c) sums component c of row t, so consecutive threads read the C
// components of a gathered row, and write those of an out row, together.
template <typename T, int V, int CC>
__global__ void __launch_bounds__(kRows * CC)
    ell_scatter_kernel(const Args<T> a) {
  __shared__ int32_t js[kRows][V];
  __shared__ int64_t ds[kRows];
  const int t = threadIdx.x / CC, c = threadIdx.x - t * CC;
  for (int64_t base = (int64_t)blockIdx.x * kRows; base < a.n_rows;
       base += (int64_t)gridDim.x * kRows) {
    if (threadIdx.x < kRows && base + threadIdx.x < a.n_rows) {
      const int64_t r = base + threadIdx.x;
      ds[threadIdx.x] = a.rows ? (int64_t)__ldg(a.rows + r) : r;
      const int32_t* irow = a.idx + r * V;
#pragma unroll
      for (int v = 0; v < V; ++v) js[threadIdx.x][v] = __ldg(irow + v);
    }
    __syncthreads();
    if (base + t < a.n_rows) {
      T* dst = a.out + ds[t] * CC + c;
      const T prev = a.accumulate ? *dst : T(0);
      T x[V];
      bool ok[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {  // issue every load before the first add
        const int32_t j = js[t][v];
        ok[v] = j >= 0 && j < a.n_flat;
        x[v] = T(0);
        if (ok[v]) x[v] = __ldg(a.flat + (int64_t)j * CC + c);  // predicated
      }
      T acc = T(0);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (ok[v]) acc += x[v];
      }
      *dst = a.accumulate ? prev + acc : acc;
    }
    __syncthreads();  // js and ds are refilled for the next tile
  }
}

// Any other max_val or C: one thread per (row, component), the index row
// read from global memory for each component.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ell_scatter_generic_kernel(const Args<T> a) {
  const int64_t total = a.n_rows * a.C;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t r = i / a.C, c = i - r * a.C;
    const int64_t d = a.rows ? (int64_t)__ldg(a.rows + r) : r;
    const int32_t* irow = a.idx + r * a.max_val;
    T acc = T(0);
    for (int v = 0; v < a.max_val; ++v) {
      const int64_t j = __ldg(irow + v);
      if (j >= 0 && j < a.n_flat) acc += __ldg(a.flat + j * a.C + c);
    }
    T* dst = a.out + d * a.C + c;
    *dst = a.accumulate ? *dst + acc : acc;
  }
}

__global__ void ell_noop_kernel() {}

// Blocks for `items` work items at `per_block` a block, capped (the kernels
// stride over the rest).
unsigned grid_for(int64_t items, int per_block) {
  int64_t blocks = (items + per_block - 1) / per_block;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

// Each launcher starts the empty kernel on its grid in place of the real one
// when `noop` is set (`ell_noop`).
template <typename T, int V, int CC>
int run(const Args<T>& a, bool noop, void* stream) {
  const unsigned grid = grid_for(a.n_rows, kRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noop)
    ell_noop_kernel<<<grid, kRows * CC, 0, s>>>();
  else
    ell_scatter_kernel<T, V, CC><<<grid, kRows * CC, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run_generic(const Args<T>& a, bool noop, void* stream) {
  const unsigned grid = grid_for(a.n_rows * a.C, kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noop)
    ell_noop_kernel<<<grid, kThreads, 0, s>>>();
  else
    ell_scatter_generic_kernel<T><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int dispatch_c(const Args<T>& a, bool noop, void* stream) {
  switch (a.C) {
    case 1: return run<T, V, 1>(a, noop, stream);
    case 3: return run<T, V, 3>(a, noop, stream);
    case 9: return run<T, V, 9>(a, noop, stream);
    default: return run_generic<T>(a, noop, stream);
  }
}

template <typename T>
int launch(const void* idx, const void* rows, const void* flat, void* out,
           long long n_rows, int max_val, long long n_flat, int C,
           int accumulate, bool noop, void* stream) {
  if (n_rows <= 0 || C <= 0) return (int)cudaSuccess;
  const Args<T> a{static_cast<const int32_t*>(idx),
                  static_cast<const int32_t*>(rows),
                  static_cast<const T*>(flat), static_cast<T*>(out),
                  (int64_t)n_rows, (int64_t)n_flat, max_val, C, accumulate};
  switch (max_val) {
    case 1: return dispatch_c<T, 1>(a, noop, stream);
    case 2: return dispatch_c<T, 2>(a, noop, stream);
    case 4: return dispatch_c<T, 4>(a, noop, stream);
    case 6: return dispatch_c<T, 6>(a, noop, stream);
    case 8: return dispatch_c<T, 8>(a, noop, stream);
    default: return run_generic<T>(a, noop, stream);
  }
}

}  // namespace

#define ELL_ENTRY_POINTS(T, SUFFIX)                                          \
  extern "C" int ell_scatter_##SUFFIX(                                       \
      const void* idx, const void* flat, void* out, long long n_rows,        \
      int max_val, long long n_flat, int C, void* stream) {                  \
    return launch<T>(idx, nullptr, flat, out, n_rows, max_val, n_flat, C, 0, \
                     false, stream);                                         \
  }                                                                          \
  extern "C" int ell_scatter_add_##SUFFIX(                                   \
      const void* idx, const void* rows, const void* flat, void* out,        \
      long long n_rows, int max_val, long long n_flat, int C,                \
      void* stream) {                                                        \
    return launch<T>(idx, rows, flat, out, n_rows, max_val, n_flat, C, 1,    \
                     false, stream);                                         \
  }

ELL_ENTRY_POINTS(float, f32)
ELL_ENTRY_POINTS(double, f64)

// An empty kernel on the grid that a call over n_rows rows of C components
// at valence max_val launches (chosen by the same `launch` switch): the
// device time of a launch that does no work, the floor of a latency-bound
// call.
extern "C" int ell_noop(long long n_rows, int max_val, int C, void* stream) {
  return launch<float>(nullptr, nullptr, nullptr, nullptr, n_rows, max_val, 0,
                       C, 0, true, stream);
}
