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
//                        (colptr[D+1], rows, vals), as a merge-path
//                        segmented reduction (below).
//
// Semantics shared with the plain PyTorch versions in
// photon_tpu_torch/ops/cuda_sparse.py:
//   * an entry whose column lies outside [0, dim) (the ELL ghost column
//     == dim, value 0) contributes 0, as does a CSC entry whose row lies
//     outside [0, n_rows); nothing is read out of bounds;
//   * duplicate columns within a row accumulate; an empty column gives 0;
//   * every sum runs in an order fixed by the inputs' layout alone, and no
//     float atomics are used, so two runs give bit-identical results;
//   * sums accumulate in double and round once to the value type;
//   * offsets are 64-bit: N*K passes 2^31 at the repository's largest
//     configured scale.
//
// What bounds them on an H100: device-memory bytes in principle. Each
// entry streams 8 bytes (a 4-byte index and a 4-byte f32 value; 12 for
// f64) once, and the outputs are written once: at ~3.35 TB/s, 2^19 rows x
// 32 entries is about 40 us. In practice the random 4-byte gathers of the
// vector (w or v, a few MB, held in the 50 MB L2) bound them: each costs a
// 32-byte L2 sector. The arithmetic (two flops an entry) is far below any
// compute bound.
//
// The transpose as a merge-path segmented reduction (Merrill and Garland,
// "Merge-based Parallel Sparse Matrix-Vector Multiplication", SC'16). The
// column ends colptr[1:] and the entries 0..nnz-1 merge into dim + nnz
// items (column c's end after its entries), cut into tiles of kTileItems
// items; the host computes each tile's start (column, entry) once per
// layout (`merge_path_tiles`). One block takes one tile, so its work does
// not depend on any column's length: a hot column (an intercept present in
// every row) spreads over many blocks instead of one warp. In the block:
//   1. the tile's column ends (relative to its first entry) and the
//      products val * v[row] of its entries go to shared memory; the
//      contiguous loads are coalesced, and each thread has all of its
//      kCscItemsPerThread gathers of v in flight at once;
//   2. each thread finds its start in the tile by a binary search of the
//      shared column ends and walks kCscItemsPerThread consecutive items
//      in double, writing g for each column that begins and ends inside
//      its run;
//   3. a block-wide segmented inclusive scan of the threads' open-column
//      partials (warp shuffles, then the warps in turn: a fixed tree) gives
//      each thread the part of its first column summed by the threads
//      before it. A column that began in an earlier tile is not written:
//      its head partial goes to a float64 scratch buffer, as does the
//      partial of the column still open at the tile's end (its tail).
// A second, small launch (`csc_fixup_kernel`) finishes each column that
// crosses a tile boundary (`split_columns`): one warp sums its tails in a
// fixed lane-strided order and a fixed butterfly, adds the head and writes
// g once. The order of every sum thus depends only on the layout and the
// tile size.
//
// The tile's rows and values come in by plain coalesced loads, not by
// cp.async: on an H100 a persistent variant that double-buffered the next
// tile with cp.async ran slower than many resident blocks, which hide the
// latency of each other's gathers (small tiles, 32 registers a thread,
// 8 blocks an SM).
//
// Interface: plain C, loaded with ctypes. Every pointer and the stream are
// passed as void*; each entry point launches on the caller's stream,
// allocates nothing (the caller passes the transpose's scratch buffer),
// and returns cudaGetLastError() (0 on success).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;              // 8 warps per block
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int64_t kMaxBlocks = 132 * 32;   // grid-stride beyond this

// Transpose tile: kCscThreads threads x kCscItemsPerThread merge-path items
// (CSC_THREADS, CSC_ITEMS_PER_THREAD in cuda_sparse.py). Shared memory per
// block: 8 + 4 bytes per item and 8 per thread, 14 KB, so that with at most
// 32 registers a thread kCscMinBlocks blocks fill an SM: the kernel waits on
// its gathers of v, and more resident blocks hide more of that latency.
constexpr int kCscThreads = 256;
constexpr int kCscItemsPerThread = 4;
constexpr int kCscMinBlocks = 8;
constexpr int kCscWarps = kCscThreads / kWarp;
constexpr int kTileItems = kCscThreads * kCscItemsPerThread;

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
__global__ void __launch_bounds__(kCscThreads, kCscMinBlocks)
csc_tile_kernel(const int64_t* __restrict__ colptr,
                const int32_t* __restrict__ rows, const T* __restrict__ vals,
                const T* __restrict__ v, const int64_t* __restrict__ tiles,
                double* __restrict__ partials, T* __restrict__ g,
                int64_t n_rows) {
  __shared__ double s_prod[kTileItems];     // entry products, tile order
  __shared__ int32_t s_ends[kTileItems];    // column ends - first entry
  __shared__ double s_scan[kCscThreads];    // segmented scan of tails
  __shared__ double s_wsum[kCscWarps];
  __shared__ int32_t s_wkey[kCscWarps];

  const int tid = threadIdx.x;
  const int64_t tile = blockIdx.x;
  const int64_t i0 = tiles[2 * tile], j0 = tiles[2 * tile + 1];
  const int nc = (int)(tiles[2 * tile + 2] - i0);   // column ends in tile
  const int ne = (int)(tiles[2 * tile + 3] - j0);   // entries in tile
  const int n_items = nc + ne;

  // 1. Stage the column ends and the entry products.
  for (int c = tid; c < nc; c += kCscThreads) {
    s_ends[c] = (int32_t)(colptr[i0 + 1 + c] - j0);
  }
  int32_t r[kCscItemsPerThread];
  T x[kCscItemsPerThread];
  T vr[kCscItemsPerThread];
#pragma unroll
  for (int k = 0; k < kCscItemsPerThread; ++k) {
    const int e = tid + k * kCscThreads;
    r[k] = -1;
    x[k] = T(0);
    if (e < ne) {
      r[k] = rows[j0 + e];
      x[k] = vals[j0 + e];
    }
  }
  bool ok[kCscItemsPerThread];
#pragma unroll
  for (int k = 0; k < kCscItemsPerThread; ++k) {
    ok[k] = r[k] >= 0 && (int64_t)r[k] < n_rows;
    vr[k] = ok[k] ? v[r[k]] : T(0);
  }
#pragma unroll
  for (int k = 0; k < kCscItemsPerThread; ++k) {
    const int e = tid + k * kCscThreads;
    if (e < ne) {
      Acc a = (Acc)x[k];
      if (SQUARE) a = a * a;
      s_prod[e] = ok[k] ? a * (Acc)vr[k] : Acc(0);
    }
  }
  __syncthreads();

  // 2. This thread's start: col = #{c : column end c lies before item d}.
  const int d = min(tid * kCscItemsPerThread, n_items);
  int lo = max(0, d - ne), hi = min(d, nc);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_ends[mid] + mid < d) lo = mid + 1; else hi = mid;
  }
  int col = lo, y = d - lo;
  const int first_col = col;
  const int d_end = min(d + kCscItemsPerThread, n_items);
  Acc run = Acc(0), head = Acc(0);
  bool emitted = false;
  for (int item = d; item < d_end; ++item) {
    const int end = col < nc ? s_ends[col] : INT_MAX;
    if (y < end) {
      run += s_prod[y];
      ++y;
    } else {
      if (emitted) {
        g[i0 + col] = (T)run;
      } else {
        head = run;
        emitted = true;
      }
      run = Acc(0);
      ++col;
    }
  }

  // 3. Segmented inclusive scan of the open-column partials (key: column).
  // Keys never decrease from thread to thread, so equal keys at a distance
  // mean equal keys in between.
  const int lane = tid % kWarp, warp = tid / kWarp;
  Acc s = run;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const Acc o = __shfl_up_sync(0xffffffffu, s, off);
    const int okey = __shfl_up_sync(0xffffffffu, col, off);
    if (lane >= off && okey == col) s = o + s;
  }
  if (lane == kWarp - 1) {
    s_wsum[warp] = s;
    s_wkey[warp] = col;
  }
  __syncthreads();
  Acc carry = Acc(0);
  for (int u = warp - 1; u >= 0 && s_wkey[u] == col; --u) carry += s_wsum[u];
  s = s + carry;
  s_scan[tid] = s;
  __syncthreads();

  // The thread before this one ended on this thread's first column.
  if (emitted) {
    const Acc value = (tid > 0 ? s_scan[tid - 1] : Acc(0)) + head;
    if (first_col == 0 && colptr[i0] < j0) {
      partials[2 * tile] = value;          // head of a split column
    } else {
      g[i0 + first_col] = (T)value;
    }
  }
  if (tid == kCscThreads - 1) partials[2 * tile + 1] = s;   // tail
}

// Finish the columns that cross a tile boundary: splits[s] = (c, a, h),
// column c's tails in tiles a..h-1 and its head in tile h.
template <typename T>
__global__ void __launch_bounds__(kThreads)
csc_fixup_kernel(const int64_t* __restrict__ splits, int64_t n_splits,
                 const double* __restrict__ partials, T* __restrict__ g) {
  const int lane = threadIdx.x % kWarp;
  const int64_t first = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t sp = first; sp < n_splits; sp += stride) {
    const int64_t c = splits[3 * sp], a = splits[3 * sp + 1];
    const int64_t h = splits[3 * sp + 2];
    Acc acc = Acc(0);
    for (int64_t t = a + lane; t < h; t += kWarp) acc += partials[2 * t + 1];
    acc = warp_sum(acc);
    if (lane == 0) g[c] = (T)(acc + partials[2 * h]);
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
                   const void* v, const void* tiles, const void* splits,
                   void* partials, void* g, int64_t n_tiles, int64_t n_splits,
                   int64_t n_rows, int64_t tile_items, void* stream) {
  if (tile_items != kTileItems || n_tiles < 1 || n_tiles > INT_MAX ||
      n_splits < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  csc_tile_kernel<T, SQUARE><<<(unsigned)n_tiles, kCscThreads, 0, st>>>(
      (const int64_t*)colptr, (const int32_t*)rows, (const T*)vals,
      (const T*)v, (const int64_t*)tiles, (double*)partials, (T*)g, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 0) return (int)err;
  csc_fixup_kernel<T><<<(unsigned)blocks_for(n_splits), kThreads, 0, st>>>(
      (const int64_t*)splits, n_splits, (const double*)partials, (T*)g);
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
    const void* v, const void* tiles, const void* splits, void* partials,
    void* g, int64_t n_tiles, int64_t n_splits, int64_t n_rows,
    int64_t tile_items, void* stream) {
  return launch_rmatvec<float, false>(colptr, rows, vals, v, tiles, splits,
      partials, g, n_tiles, n_splits, n_rows, tile_items, stream);
}

int csc_rmatvec_f64(const void* colptr, const void* rows, const void* vals,
    const void* v, const void* tiles, const void* splits, void* partials,
    void* g, int64_t n_tiles, int64_t n_splits, int64_t n_rows,
    int64_t tile_items, void* stream) {
  return launch_rmatvec<double, false>(colptr, rows, vals, v, tiles, splits,
      partials, g, n_tiles, n_splits, n_rows, tile_items, stream);
}

int csc_sq_rmatvec_f32(const void* colptr, const void* rows, const void* vals,
    const void* v, const void* tiles, const void* splits, void* partials,
    void* g, int64_t n_tiles, int64_t n_splits, int64_t n_rows,
    int64_t tile_items, void* stream) {
  return launch_rmatvec<float, true>(colptr, rows, vals, v, tiles, splits,
      partials, g, n_tiles, n_splits, n_rows, tile_items, stream);
}

int csc_sq_rmatvec_f64(const void* colptr, const void* rows, const void* vals,
    const void* v, const void* tiles, const void* splits, void* partials,
    void* g, int64_t n_tiles, int64_t n_splits, int64_t n_rows,
    int64_t tile_items, void* stream) {
  return launch_rmatvec<double, true>(colptr, rows, vals, v, tiles, splits,
      partials, g, n_tiles, n_splits, n_rows, tile_items, stream);
}

const char* ell_sparse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
