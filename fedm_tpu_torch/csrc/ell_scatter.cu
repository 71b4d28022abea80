// ELL gather-sum for Hopper (sm_90a):  out[d, c] = sum_v flat[idx[d, v], c].
//
// Replaces the TPU kernel fedm_tpu/ops/pallas_scatter.py:_ell_kernel
// (pallas_ell_scatter), which tiled 512 dofs per grid step, handled one
// trailing component per call, and read pad entries from a sentinel zero row
// appended to `flat`. Here the trailing axis is fused (the wrapper flattens
// it to one width C) and any index outside [0, n_flat) contributes zero, so
// no sentinel row has to be concatenated onto `flat`.
//
// What bounds it: bytes. Each output element costs max_val index reads and
// up to max_val gathered reads for one add each — well under one operation
// per byte, far below the card's float32/float64 rates. The least traffic is
// idx (n_dofs*max_val*4 B) + flat (n_flat*C*sizeof(T)) + out
// (n_dofs*C*sizeof(T)). The design keeps that traffic near its minimum: one
// thread per (d, c), consecutive threads on consecutive outputs, so the
// stores coalesce and the C threads of one dof read the same idx row (one
// cache line); the sum stays in a register, and the gathered `flat` rows of
// neighbouring dofs share cache lines because the ELL order follows the
// element order. The plain C interface (raw pointers, sizes, a stream) keeps
// PyTorch's headers out, so nvcc builds this file in seconds.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T>
__global__ void ell_scatter_kernel(const int32_t* __restrict__ idx,
                                   const T* __restrict__ flat,
                                   T* __restrict__ out, int64_t n_dofs,
                                   int max_val, int64_t n_flat, int C) {
  const int64_t total = n_dofs * C;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t d = i / C;
    const int64_t c = i - d * C;
    const int32_t* row = idx + d * max_val;
    T acc = T(0);
    for (int v = 0; v < max_val; ++v) {
      const int64_t j = __ldg(row + v);
      if (j >= 0 && j < n_flat) acc += __ldg(flat + j * C + c);
    }
    out[i] = acc;
  }
}

template <typename T>
int launch(const void* idx, const void* flat, void* out, long long n_dofs,
           int max_val, long long n_flat, int C, void* stream) {
  const int64_t total = (int64_t)n_dofs * C;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride
  ell_scatter_kernel<T><<<(unsigned)blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const T*>(flat),
      static_cast<T*>(out), (int64_t)n_dofs, max_val, (int64_t)n_flat, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ell_scatter_f32(const void* idx, const void* flat, void* out,
                               long long n_dofs, int max_val, long long n_flat,
                               int C, void* stream) {
  return launch<float>(idx, flat, out, n_dofs, max_val, n_flat, C, stream);
}

extern "C" int ell_scatter_f64(const void* idx, const void* flat, void* out,
                               long long n_dofs, int max_val, long long n_flat,
                               int C, void* stream) {
  return launch<double>(idx, flat, out, n_dofs, max_val, n_flat, C, stream);
}
