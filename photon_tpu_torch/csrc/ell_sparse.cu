// ELL sparse passes for Hopper (sm_90a): the matvec and its transpose.
//
// Replaces the TPU kernel `_gather_onehot_kernel`, launched by `_run_op` in
// photon_tpu/ops/pallas_sparse.py and reached through `matvec_pallas`
// (z = A w) and `rmatvec_pallas` (g = A^T dz, and with square_vals the
// Hessian-diagonal form g = (A.A)^T dz). The TPU version repacks entries
// into 128-lane slot tables and reduces them with a one-hot MXU product;
// all of that is a TPU layout. Here the function is ported, not the layout:
//
//   ell_matvec<T>        z[r] = sum_k val[r,k] * w[idx[r,k]]
//                        one warp per row, lanes striding over K.
//   csc_rmatvec<T, SQ>   g[c] = sum over entries e of column c of
//                        val[e] (val[e]^2 when SQ) * v[rows[e]]
//                        over a host-built, column-sorted entry list
//                        (colptr[D+1], rows, vals); one warp per column.
//
// Semantics shared with the plain PyTorch versions in
// photon_tpu_torch/ops/cuda_sparse.py:
//   * an entry whose column lies outside [0, dim) (the ELL ghost column
//     == dim, value 0) contributes 0, and nothing is read out of bounds;
//   * duplicate columns within a row accumulate;
//   * every per-row and per-column sum runs in a fixed order (lane-strided
//     partials, then a fixed xor-butterfly of warp shuffles), and no float
//     atomics are used, so two runs give bit-identical results;
//   * sums accumulate in double and round once to the value type;
//   * offsets are 64-bit: N*K passes 2^31 at the repository's largest
//     configured scale.
//
// What bounds them on an H100: device-memory bytes. Each entry streams
// 8 bytes (a 4-byte index and a 4-byte f32 value; 12 for f64) once, and the
// outputs are written once. The gathered vector (w or v, at most a few MB
// at the scoring widths) stays in the 50 MB L2, so its reads cost L2
// bandwidth rather than HBM. At ~3.35 TB/s, 2^19 rows x 32 entries is about
// 40 us. The per-row warp gives fully coalesced 128-byte loads of idx and
// val; the arithmetic (two flops an entry) is far below any compute bound.
//
// Known limits, left for later work: a hot column (an intercept present in
// every row) makes one warp of csc_rmatvec walk N entries while the others
// finish early; splitting long segments, and a TMA-fed or wgmma-based
// variant, are speed work for a later change.
//
// Interface: plain C, loaded with ctypes. Every pointer and the stream are
// passed as void*; each entry point launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;              // 8 warps per block
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int64_t kMaxBlocks = 132 * 32;   // grid-stride beyond this

// Sums accumulate in double for both value types: a float product is exact
// in double, so a float result is the correctly rounded sum in all but rare
// ties, and a hot column's long sum loses no digits. It costs nothing
// measurable in a kernel bound by memory bytes.
using Acc = double;

template <typename T>
__device__ __forceinline__ T warp_sum(T acc) {
  // Fixed butterfly: every lane ends with the same, order-fixed sum.
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_matvec_kernel(const int32_t* __restrict__ idx, const T* __restrict__ val,
                  const T* __restrict__ w, T* __restrict__ z, int64_t n,
                  int64_t k, int64_t dim) {
  const int lane = threadIdx.x % kWarp;
  const int64_t first = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t r = first; r < n; r += stride) {
    const int32_t* ri = idx + r * k;
    const T* rv = val + r * k;
    Acc acc = Acc(0);
    for (int64_t j = lane; j < k; j += kWarp) {
      const int64_t c = ri[j];
      if (c >= 0 && c < dim) acc += (Acc)rv[j] * (Acc)w[c];
    }
    acc = warp_sum(acc);
    if (lane == 0) z[r] = (T)acc;
  }
}

template <typename T, bool SQUARE>
__global__ void __launch_bounds__(kThreads)
csc_rmatvec_kernel(const int64_t* __restrict__ colptr,
                   const int32_t* __restrict__ rows, const T* __restrict__ vals,
                   const T* __restrict__ v, T* __restrict__ g, int64_t dim,
                   int64_t n_rows) {
  const int lane = threadIdx.x % kWarp;
  const int64_t first = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t c = first; c < dim; c += stride) {
    const int64_t lo = colptr[c];
    const int64_t hi = colptr[c + 1];
    Acc acc = Acc(0);
    for (int64_t e = lo + lane; e < hi; e += kWarp) {
      const int64_t r = rows[e];
      if (r >= 0 && r < n_rows) {
        Acc x = (Acc)vals[e];
        if (SQUARE) x = x * x;
        acc += x * (Acc)v[r];
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) g[c] = (T)acc;
  }
}

int64_t blocks_for(int64_t warps) {
  int64_t b = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : b;
}

template <typename T>
int launch_matvec(const void* idx, const void* val, const void* w, void* z,
                  int64_t n, int64_t k, int64_t dim, void* stream) {
  ell_matvec_kernel<T><<<(unsigned)blocks_for(n), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const T*)val, (const T*)w, (T*)z, n, k, dim);
  return (int)cudaGetLastError();
}

template <typename T, bool SQUARE>
int launch_rmatvec(const void* colptr, const void* rows, const void* vals,
                   const void* v, void* g, int64_t dim, int64_t n_rows,
                   void* stream) {
  csc_rmatvec_kernel<T, SQUARE><<<(unsigned)blocks_for(dim), kThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const int64_t*)colptr, (const int32_t*)rows, (const T*)vals,
      (const T*)v, (T*)g, dim, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ell_matvec_f32(const void* idx, const void* val, const void* w, void* z,
                   int64_t n, int64_t k, int64_t dim, void* stream) {
  return launch_matvec<float>(idx, val, w, z, n, k, dim, stream);
}

int ell_matvec_f64(const void* idx, const void* val, const void* w, void* z,
                   int64_t n, int64_t k, int64_t dim, void* stream) {
  return launch_matvec<double>(idx, val, w, z, n, k, dim, stream);
}

int csc_rmatvec_f32(const void* colptr, const void* rows, const void* vals,
                    const void* v, void* g, int64_t dim, int64_t n_rows,
                    void* stream) {
  return launch_rmatvec<float, false>(colptr, rows, vals, v, g, dim, n_rows,
                                      stream);
}

int csc_rmatvec_f64(const void* colptr, const void* rows, const void* vals,
                    const void* v, void* g, int64_t dim, int64_t n_rows,
                    void* stream) {
  return launch_rmatvec<double, false>(colptr, rows, vals, v, g, dim, n_rows,
                                       stream);
}

int csc_sq_rmatvec_f32(const void* colptr, const void* rows, const void* vals,
                       const void* v, void* g, int64_t dim, int64_t n_rows,
                       void* stream) {
  return launch_rmatvec<float, true>(colptr, rows, vals, v, g, dim, n_rows,
                                     stream);
}

int csc_sq_rmatvec_f64(const void* colptr, const void* rows, const void* vals,
                       const void* v, void* g, int64_t dim, int64_t n_rows,
                       void* stream) {
  return launch_rmatvec<double, true>(colptr, rows, vals, v, g, dim, n_rows,
                                      stream);
}

const char* ell_sparse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
