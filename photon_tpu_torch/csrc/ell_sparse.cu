// ELL sparse passes for Hopper (sm_90a): the matvec and its transpose.
//
// Replaces the TPU kernel `_gather_onehot_kernel`, launched by `_run_op` in
// photon_tpu/ops/pallas_sparse.py and reached through `matvec_pallas`
// (z = A w) and `rmatvec_pallas` (g = A^T dz, and with square_vals the
// Hessian-diagonal form g = (A.A)^T dz). The TPU version repacks entries
// into 128-lane slot tables and reduces them with a one-hot MXU product;
// all of that is a TPU layout. Here the function is ported, not the layout:
//
//   ell_panel_matvec<T>  z[r] = sum_k val[r,k] * w[idx[r,k]]
//                        over a panel-sorted entry list (below): w staged
//                        in shared memory one column panel at a time.
//   ell_matvec<T>        the same sum straight from the ELL arrays, as a
//                        stream of row tiles (below); for layouts where
//                        reloading w for every row tile would cost more
//                        than its gathers.
//   csc_rmatvec<T, SQ>   g[c] = sum over entries e of column c of
//                        val[e] (val[e]^2 when SQ) * v[rows[e]]
//                        over a host-built, column-sorted entry list
//                        (colptr[D+1], rows, vals), as a merge-path
//                        segmented reduction (below).
//   csc_panel_rmatvec<V, SQ>  the same sum over a row-panel transpose
//                        layout (below): v staged in shared memory one row
//                        panel at a time; the bf16 transposes' route where
//                        the host's rule finds it pays.
//
// Each kernel is a template on the stored value type V and on T, the type
// of the vector and the result: V = T in float or double (the `_f32` /
// `_f64` entry points), or V = bfloat16 with T = float (`_bf16`, the
// values stored narrow: `with_value_dtype`, the bf16 feed). A bfloat16
// value is a float with the low 16 mantissa bits zero, so the upcast on
// load is exact and, since no summation order depends on V, a bf16 kernel
// gives the bits of its float kernel run on the upcast values (held so on
// the card by tests/test_torch_bf16.py). The layouts keep their float
// shape: a bf16 panel layout is the float one (w stays float in shared
// memory), the row-tile plan keeps its rows a multiple of 8 / gcd(K, 8) so
// that a tile's value run stays a multiple of 16 bytes, and the 2-byte
// values of a chunk load 8 bytes at a time.
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
// f64, 6 for bf16) once, and the outputs are written once: at ~3.35 TB/s,
// 2^19 rows x 32 entries is about 40 us. Gathering the vector (w or v, a few MB, held
// in the 50 MB L2) at random costs one 32-byte L2 sector per 4-byte read,
// which the bytes bound cannot see: on the GAME layout 537 MB of sector
// traffic against 134 MB of streamed entries. The arithmetic (two flops an
// entry) is far below any compute bound.
//
// The matvec over column panels. The rows are cut into tiles of R rows
// (a power of two in [1,024, 8,192], so that the tiles cover the 132 SMs)
// and the columns into panels of kPanelBytes / sizeof(T) columns, one
// shared-memory stage. The host sorts the entries once per layout
// (`build_panels`) by (tile, panel), stably, so that within a segment the
// rows ascend and each row keeps its ELL order; each entry is one 32-bit
// code (row in tile << 16 | column in panel) and its value, and each
// segment is padded with skip entries (kPadKey, value 0) to a multiple of 4
// so that every segment starts 16-byte aligned. One block takes one tile:
//   1. the panels of w holding the tile's entries come into a two-stage
//      ring in shared memory by TMA bulk copies (cp.async.bulk, completing
//      on an mbarrier): panel p+1 loads while panel p is gathered, and a
//      panel with no entries in the tile is skipped. The gathers of w then
//      hit shared memory; w crosses L2 once per tile in whole lines;
//   2. the segment's entries stream in chunks of kPanelChunk, each thread
//      loading its kPanelItems consecutive entries with 16-byte loads into
//      registers: the next chunk's loads go out as soon as this one's
//      entries are walked and are in flight during its scan, and the chunk
//      after it is on its way into L2 (cp.async.bulk.prefetch); the tile's
//      segment offsets, read at every chunk, sit in shared memory;
//   3. each row's partial in the panel comes from the transpose's walk and
//      block segmented scan (SegmentWalk, block_segmented_scan), with the
//      row as the key: a row that crosses a chunk boundary carries into
//      the next chunk's first thread;
//   4. exactly one thread adds each row's panel partial into the row's
//      double accumulator in shared memory, in panel order; at the end
//      each row rounds once and writes z.
// Reloading w costs ceil(N/R) * dim * sizeof(T) bytes of L2 traffic
// against nnz * 32 bytes of sectors for the gathers; the host keeps
// ell_matvec where the reloads cost more. Measured on an H100 at 2^19 rows
// x 32 entries (f32): the reloads cost ~5% of the kernel's time and the
// block scan ~15%; the rest is streaming the entries and the walk.
//
// The matvec over row tiles (`ell_matvec`, replacing `matvec_pallas`,
// photon_tpu/ops/pallas_sparse.py:331, where `build_panels` declines: the
// random-effect lanes' block-diagonal layouts and short-row driver batches).
// What bounds it: the entries, 8 bytes each in f32 (12 in f64), streamed
// once, and w, each column read about once where the rows' columns are
// local (a lane's rows gather from its own P-column window, which stays in
// L1 and L2). A warp per row would leave half its lanes idle at K = 17,
// load each row as a misaligned 68-byte run and run every row as one
// dependent chain of index load, gather, add and shuffle tree: on an H100
// it takes twice this kernel's time on the lanes (tools/ell_ablation.py),
// though 13% less at 32 entries a row over spread columns, where gathering
// w from L2 sets the pace. Here:
//   1. a tile is R consecutive rows, so its R*K indices and R*K values are
//      one contiguous run of each array; the host picks R from K (and the
//      value type) so that R*K*sizeof is a multiple of 16 bytes and two
//      stages fit shared memory. Persistent blocks walk the tiles; the next
//      tile's two runs come into a two-stage ring in shared memory by TMA
//      bulk copies (completing on an mbarrier) while the current one is
//      summed. A run's part before its first 16-byte boundary and after its
//      last (a row-sliced view, the short last tile, a long row) comes by
//      plain loads of a few threads, so any contiguous input works. A row
//      longer than a stage (K > stage / 4) is a tile of its own, brought in
//      stage-sized chunks;
//   2. a group of G threads sums each row, G = the least power of two with
//      G * kEllItems >= K (at most the block). Thread g sums its contiguous
//      slice [g*L, (g+1)*L) of the row, L = ceil(K/G), in k order in double,
//      reading the slice from shared memory: its up to kEllItems gathers of
//      w are in flight at once. The G partials combine by a fixed pairwise
//      tree: shuffles at distances min(G, 32)/2 .. 1, then, for G > 32, the
//      warps' sums in shared memory at distances G/64 .. 1. Consecutive
//      groups take consecutive rows, so the stores of z coalesce.
// The order of every sum depends on K alone (through G and L), never on R,
// the grid or the card; an entry outside [0, dim) adds nothing and reads no
// w. Shared memory is read once per entry (8 or 12 bytes against the SM's
// 128 bytes a cycle), so bank conflicts at even K are left as they fall:
// on an H100, K = 31, 32 and 33 take the same time (tools/ell_host_cost.py).
// Measured there (f32): 82% of the bytes bound at the lanes, 1.9x faster
// than a warp per row; 12 entries a load ran faster than 8 or 16.
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
// The transpose over row panels (`csc_panel_kernel`, replacing
// `rmatvec_pallas`, photon_tpu/ops/pallas_sparse.py:313, for the bf16
// transposes where `transpose_panels_pay_off` sends a layout). The merge
// path above gathers v[rows[e]] for every entry from rows spread over all
// of v: each 4-byte gather pulls a 32-byte L2 sector (at 2^19 rows x 33
// entries ~550 MB of sectors against ~100 MB of streamed bf16 entries), and
// a 2-byte value saves 2 of ~38 bytes an entry. This kernel is the panel
// matvec's mirror: the columns are cut into tiles of C columns (a power of
// two in [1,024, 8,192]) and the rows into panels of kPanelBytes / 4 rows
// (16,384: one shared-memory stage of the float v). The host's layout
// (`row_panel_layout`, built on the device) sorts the entries once by
// (tile, panel) and, within a segment, by (column, row), stably; each entry
// is one 32-bit code (column in tile << 16 | row in panel) and its value,
// and each segment is padded with skip entries (kPadKey, value 0) to a
// multiple of 4, so that it starts 16-byte aligned. A band is one tile over
// a run of consecutive panels. The host cuts the sequence of segments, in
// (tile, panel) order, into one run a block (132 blocks, one an SM, all in
// one wave) of about the same work, counted as the entries plus a fixed
// cost a non-empty segment and a band (a panel's wait and a chunk's scan,
// the accumulators' clearing and flushing: a run of sparse segments is
// work too), and each run into bands at the tiles' edges. Each block walks
// its bands in order, running the matvec's panel loop (`panel_sum`) with
// the column as the key: the band's panels of v come into a two-stage ring
// by TMA bulk copies (an empty panel skipped; the ring carries on from
// band to band), its entries stream in chunks by 16-byte loads, each
// gather of v hits shared memory, and exactly one thread adds each
// column's panel partial into the column's double accumulator, in panel
// order. A tile held whole by one band rounds each column once and writes
// g; the bands of a tile cut between blocks write their double partials to
// a scratch row each, and `csc_band_fixup_kernel` sums them in
// band order and rounds once. The order of every sum depends only on the
// layout. v crosses L2 once per tile in whole lines, n_tiles * n_rows * 4
// bytes, against nnz * 32 bytes of sectors for the merge path's gathers.
//
// Interface: plain C, loaded with ctypes. Every pointer and the stream are
// passed as void*; each entry point launches on the caller's stream,
// allocates nothing (the caller passes the transpose's scratch buffer),
// and returns a CUDA error code (0 on success).

#include <climits>
#include <cuda_bf16.h>
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

// Panel matvec (PANEL_THREADS, PANEL_ITEMS, PANEL_BYTES, MAX_TILE_ROWS,
// PAD_ROW in cuda_sparse.py): kPanelThreads threads each take kPanelItems
// consecutive entries of a chunk (16-byte loads of codes). Shared memory
// per block: two w stages of kPanelBytes, R doubles of row accumulators
// (64 KB at R = 8,192), the tile's P + 1 segment offsets and 8 bytes a
// thread of scan scratch, ~200 KB at most, so one block an SM. On an H100,
// 8 items a thread ran faster than 4 with 1,024 threads or 8 and 16 with
// 512; one chunk of L2 prefetch faster than 0, 2 or 3; and loading the next
// chunk after the walk (one set of registers) faster than before it.
constexpr int kPanelThreads = 1024;
constexpr int kPanelItems = 8;             // a multiple of 4
constexpr int kPanelPrefetch = 1;          // chunks prefetched into L2 ahead
constexpr int kPanelWarps = kPanelThreads / kWarp;
constexpr int kPanelChunk = kPanelThreads * kPanelItems;
constexpr int kPanelBytes = 64 * 1024;
constexpr int kMaxTileRows = 8192;
constexpr int kCodeShift = 16;             // code = key << 16 | index
constexpr uint32_t kIdxMask = (1u << kCodeShift) - 1;
constexpr int kPadKey = 0xFFFF;            // key field of a skip entry
// A segment with fewer entries gathers its vector from device memory: its
// sectors (32 bytes a gather at most) cost less than staging the panel.
constexpr int kStageMin = kPanelBytes / 32;
// Transpose over row panels (TILE_COLS bounds, PANEL_ROWS, PAD_COL in
// cuda_sparse.py): a tile of at most kMaxTileCols columns keeps a double
// accumulator a column beside the two stages of v.
constexpr int kMaxTileCols = 8192;

// Row-tile matvec (ELL_THREADS, ELL_ITEMS in cuda_sparse.py, which also
// picks the tile's rows R, the group G and the stage's entries): a block of
// kEllThreads threads, each loading up to kEllItems entries of its slice of
// a row at once. Shared memory: two stages of (stage entries) x (4 +
// sizeof(T)) bytes, plus 16 bytes an array for the runs' offset within a
// 16-byte line.
constexpr int kEllThreads = 256;
constexpr int kEllItems = 12;
constexpr int kEllWarps = kEllThreads / kWarp;

// Sums accumulate in double for both value types: a float product is exact
// in double, so a float result is the correctly rounded sum in all but rare
// ties, and a hot column's long sum loses no digits. It costs nothing
// measurable in a kernel bound by memory bytes.
using Acc = double;

// Stored values upcast to the accumulator on load (exactly; see the top of
// the file for the value types V and T).
using Bf16 = __nv_bfloat16;

__device__ __forceinline__ Acc upcast(float x) { return (Acc)x; }
__device__ __forceinline__ Acc upcast(double x) { return x; }
__device__ __forceinline__ Acc upcast(Bf16 x) { return (Acc)__bfloat162float(x); }

template <typename V>
__device__ __forceinline__ V vzero() { return V(0); }
template <>
__device__ __forceinline__ Bf16 vzero<Bf16>() { return __ushort_as_bfloat16((unsigned short)0); }

template <typename T>
__device__ __forceinline__ T warp_sum(T acc) {
  // Fixed butterfly: every lane ends with the same, order-fixed sum.
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  return acc;
}

// One thread's walk over its consecutive items, shared by the transpose's
// merge-path tiles (key: column) and the matvec's panel chunks (key: row).
// `run` sums the open segment; close() ends it. The first segment a thread
// closes may have begun in an earlier thread: its part here is kept as
// `head` and finished after the block scan (head_value). Every later one
// lies whole in this thread's run and goes to `emit` at once.
struct SegmentWalk {
  Acc run = Acc(0), head = Acc(0);
  bool emitted = false;

  template <typename Emit>
  __device__ __forceinline__ void close(int key, Emit&& emit) {
    if (emitted) {
      emit(key, run);
    } else {
      head = run;
      emitted = true;
    }
    run = Acc(0);
  }

  // The first closed segment's total: the open partials of the threads
  // before this one (which all ended on its key) plus this thread's head.
  __device__ __forceinline__ Acc head_value(const Acc* s_scan) const {
    return (threadIdx.x > 0 ? s_scan[threadIdx.x - 1] : Acc(0)) + head;
  }
};

// Block-wide segmented inclusive scan of the threads' open partials `s`
// under `key` (the segment each thread ends in): warp shuffles at distances
// 1..16, then the earlier warps' totals, nearest first — a fixed tree.
// Keys never decrease from thread to thread, so equal keys at a distance
// mean equal keys in between: once no lane of a warp matches at distance
// `off`, none does further off, and the warp leaves the shuffles early
// with the same sums. Returns this thread's inclusive sum and leaves every
// thread's in s_scan (readable on return).
__device__ __forceinline__ Acc block_segmented_scan(Acc s, int key, Acc* s_wsum,
                                                    int* s_wkey, Acc* s_scan) {
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int okey = __shfl_up_sync(0xffffffffu, key, off);
    const bool same = lane >= off && okey == key;
    if (!__any_sync(0xffffffffu, same)) break;
    const Acc o = __shfl_up_sync(0xffffffffu, s, off);
    if (same) s = o + s;
  }
  if (lane == kWarp - 1) {
    s_wsum[warp] = s;
    s_wkey[warp] = key;
  }
  __syncthreads();
  Acc carry = Acc(0);
  for (int u = warp - 1; u >= 0 && s_wkey[u] == key; --u) carry += s_wsum[u];
  s = s + carry;
  s_scan[tid] = s;
  __syncthreads();
  return s;
}

// ---- TMA bulk copies and mbarriers (PTX, sm_90)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Wait for the barrier's phase `parity` to complete. A copy that never
// lands (a fault the launcher's checks missed) traps after ~2^24 polls, so
// the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// Thread 0 only: order this block's earlier generic-proxy accesses of shared
// memory before the async writes to come, then arm `bar` for `bytes` of
// bulk copies in its current phase (0 completes the phase at once).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Bring panel p of w (columns p*C .. min(dim, (p+1)*C)) into `dst`,
// completing on `bar`. The 16-byte-aligned body goes by one bulk copy
// issued by thread 0; the last panel's tail (fewer than 16 bytes) by plain
// loads of the first threads, visible to the block after its next
// __syncthreads(). w must be 16-byte aligned (the wrapper checks).
template <typename T>
__device__ __forceinline__ void load_panel(T* dst, const T* __restrict__ w,
                                           int64_t dim, int p, uint64_t* bar) {
  constexpr int kCols = kPanelBytes / (int)sizeof(T);
  const int64_t c0 = (int64_t)p * kCols;
  const int cols = (int)min((int64_t)kCols, dim - c0);
  const uint32_t bulk = (uint32_t)(cols * (int)sizeof(T)) & ~15u;
  const int n_bulk = (int)(bulk / sizeof(T));
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, bulk);
    if (bulk > 0) bulk_copy(dst, w + c0, bulk, bar);
  }
  if ((int)threadIdx.x < cols - n_bulk) {
    dst[n_bulk + threadIdx.x] = w[c0 + n_bulk + threadIdx.x];
  }
}

// The next panel after p with entries in this tile (n_panels if none).
__device__ __forceinline__ int next_panel(const int64_t* off, int p, int n_panels) {
  for (++p; p < n_panels && off[p + 1] == off[p]; ++p) {
  }
  return p;
}

// The next panel after p with at least `least` entries in this tile: the
// panels the ring stages (n_panels if none).
__device__ __forceinline__ int next_staged(const int64_t* off, int p, int n_panels,
                                           int least) {
  for (++p; p < n_panels && off[p + 1] - off[p] < least; ++p) {
  }
  return p;
}

// One thread's entries of a chunk (registers), and the code of the entry
// just before them: the key its walk starts in.
template <typename V>
struct PanelChunk {
  uint32_t code[kPanelItems];
  V val[kPanelItems];
  uint32_t prev;
};

__device__ __forceinline__ void load_vals4(float* v, const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load_vals4(double* v, const double* p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Four bfloat16 values: one aligned 8-byte load (a group of 4 entries
// starts at a multiple of 4 entries of a 16-byte-aligned array).
__device__ __forceinline__ void load_vals4(Bf16* v, const Bf16* p) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __ushort_as_bfloat16((unsigned short)(a.x & 0xFFFFu));
  v[1] = __ushort_as_bfloat16((unsigned short)(a.x >> 16));
  v[2] = __ushort_as_bfloat16((unsigned short)(a.y & 0xFFFFu));
  v[3] = __ushort_as_bfloat16((unsigned short)(a.y >> 16));
}

// Chunk [pos, pos + n) of a segment: n and pos are multiples of 4 (the
// segments are padded), so each group of 4 entries of a thread is one
// aligned 16-byte load of codes.
template <typename V>
__device__ __forceinline__ void load_chunk(PanelChunk<V>& c,
                                           const uint32_t* __restrict__ codes,
                                           const V* __restrict__ vals,
                                           int64_t pos, int n) {
  const int d = (int)threadIdx.x * kPanelItems;
#pragma unroll
  for (int g = 0; g < kPanelItems; g += 4) {
    if (d + g < n) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(codes + pos + d + g));
      c.code[g] = q.x; c.code[g + 1] = q.y; c.code[g + 2] = q.z; c.code[g + 3] = q.w;
      load_vals4(c.val + g, vals + pos + d + g);
    }
  }
  c.prev = (pos + min(d, n) > 0) ? codes[pos + min(d, n) - 1] : 0u;
}

// Ask L2 for entries [a, b) of the stream ahead of the register loads
// (a, b multiples of 4: 16-byte aligned in the codes and in 4- or 8-byte
// values). A bulk prefetch takes 16-byte-aligned runs of whole 16-byte
// units, so for 2-byte values the run is cut to multiples of 8 entries:
// it is only a hint.
template <typename V>
__device__ __forceinline__ void prefetch_entries(const uint32_t* codes, const V* vals,
                                                 int64_t a, int64_t b) {
  if (b <= a) return;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
               :: "l"(codes + a), "r"((uint32_t)((b - a) * 4)) : "memory");
  constexpr int64_t kUnit = sizeof(V) >= 4 ? 4 : 16 / (int64_t)sizeof(V);
  const int64_t va = (a + kUnit - 1) / kUnit * kUnit, vb = b / kUnit * kUnit;
  if (vb <= va) return;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
               :: "l"(vals + va), "r"((uint32_t)((vb - va) * sizeof(V))) : "memory");
}

// A run of device memory as its head (the bytes before its first 16-byte
// boundary), a 16-byte-aligned body and its tail (under 16 bytes); `lead`
// is its start's offset within a 16-byte line.
struct Run {
  uint32_t lead, head, body, tail;
};

__device__ __forceinline__ Run split_run(const void* p, int64_t bytes) {
  Run r;
  r.lead = (uint32_t)((uintptr_t)p & 15u);
  r.head = r.lead ? (uint32_t)min((int64_t)(16 - r.lead), bytes) : 0u;
  r.body = (uint32_t)((bytes - r.head) & ~(int64_t)15);
  r.tail = (uint32_t)(bytes - r.head - r.body);
  return r;
}

// The plain-load part of a run that lands at dst + lead: its head and tail
// elements (fewer than 16 / sizeof(E) of each), one each from threads
// first .. first + 2 * 16 / sizeof(E) - 1.
template <typename E>
__device__ __forceinline__ void copy_run_ends(unsigned char* dst, const E* __restrict__ src,
                                              const Run& r, int first) {
  constexpr int kPer = 16 / (int)sizeof(E);
  E* out = reinterpret_cast<E*>(dst + r.lead);
  const int i = (int)threadIdx.x - first;
  if (i >= 0 && i < (int)(r.head / sizeof(E))) out[i] = src[i];
  const int j = i - kPer;
  if (j >= 0 && j < (int)(r.tail / sizeof(E))) {
    const int64_t o = (r.head + r.body) / sizeof(E) + j;
    out[o] = src[o];
  }
}

// Bring entries [e0, e1) of both ELL arrays into stage `st` (indices at st,
// values at st + stage*4 + 16), each at its run's `lead`: the bodies by two
// bulk copies completing on `bar`, the ends by plain loads (threads 32..39
// for the indices, 40.. for the values), visible to the block after its
// next __syncthreads().
template <typename V>
__device__ __forceinline__ void load_entries(unsigned char* st, int stage,
                                             const int32_t* __restrict__ idx,
                                             const V* __restrict__ val, int64_t e0,
                                             int64_t e1, uint64_t* bar) {
  unsigned char* s_idx = st;
  unsigned char* s_val = st + (int64_t)stage * 4 + 16;
  const Run ri = split_run(idx + e0, (e1 - e0) * 4);
  const Run rv = split_run(val + e0, (e1 - e0) * (int64_t)sizeof(V));
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, ri.body + rv.body);
    if (ri.body) {
      bulk_copy(s_idx + ri.lead + ri.head,
                reinterpret_cast<const unsigned char*>(idx + e0) + ri.head, ri.body, bar);
    }
    if (rv.body) {
      bulk_copy(s_val + rv.lead + rv.head,
                reinterpret_cast<const unsigned char*>(val + e0) + rv.head, rv.body, bar);
    }
  }
  copy_run_ends(s_idx, idx + e0, ri, kWarp);
  copy_run_ends(s_val, val + e0, rv, kWarp + 8);
}

// acc + the entries [lo, hi) of a stage, in order: kEllItems at a time, all
// their gathers of w in flight before the first add. An entry whose column
// lies outside [0, dim) adds nothing and reads no w.
template <typename V, typename T>
__device__ __forceinline__ Acc slice_sum(Acc acc, const int32_t* s_idx, const V* s_val,
                                         int lo, int hi, const T* __restrict__ w,
                                         int64_t dim) {
  for (int e = lo; e < hi; e += kEllItems) {
    int32_t c[kEllItems];
    V v[kEllItems];
    T x[kEllItems];
#pragma unroll
    for (int i = 0; i < kEllItems; ++i) {
      const bool in = e + i < hi;
      c[i] = in ? s_idx[e + i] : -1;
      v[i] = in ? s_val[e + i] : vzero<V>();
    }
#pragma unroll
    for (int i = 0; i < kEllItems; ++i) {
      x[i] = (c[i] >= 0 && c[i] < dim) ? __ldg(w + c[i]) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kEllItems; ++i) {
      if (c[i] >= 0 && c[i] < dim) acc = acc + __dmul_rn(upcast(v[i]), (Acc)x[i]);
    }
  }
  return acc;
}

// The sum of a group's G partials by a fixed pairwise tree: shuffles at
// distances min(G, 32)/2 .. 1 (every lane of the group ends with the same
// sum), then for G > 32 the warps' sums in shared memory at distances
// G/64 .. 1, by the group's first thread. Called by every thread of the
// block alike (it may synchronize); the group's first thread holds the sum.
__device__ __forceinline__ Acc group_sum(Acc acc, int group, Acc* s_warp) {
  for (int off = min(group, kWarp) / 2; off > 0; off >>= 1) {
    acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (group <= kWarp) return acc;
  const int warp = threadIdx.x / kWarp;
  __syncthreads();   // an earlier pass's tree is done with s_warp
  if (threadIdx.x % kWarp == 0) s_warp[warp] = acc;
  __syncthreads();
  if (threadIdx.x % group == 0) {
    Acc* t = s_warp + warp;
    for (int off = group / kWarp / 2; off > 0; off >>= 1) {
      for (int x = 0; x < off; ++x) t[x] = t[x] + t[x + off];
    }
    acc = t[0];
  }
  return acc;
}

// Persistent blocks over the row tiles; see "The matvec over row tiles"
// above. A unit of work is one stage: a whole tile, or one chunk of a long
// row's tile (tile_rows == 1, K > stage).
template <typename V, typename T>
__global__ void __launch_bounds__(kEllThreads)
ell_matvec_kernel(const int32_t* __restrict__ idx, const V* __restrict__ val,
                  const T* __restrict__ w, T* __restrict__ z, int64_t n, int64_t k,
                  int64_t dim, int tile_rows, int group, int stage) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t s_full[2];
  __shared__ Acc s_warp[kEllWarps];
  const int64_t stage_bytes = (int64_t)stage * (4 + (int64_t)sizeof(V)) + 32;

  const int tid = threadIdx.x;
  const int g = tid % group, gid = tid / group, rows_per_pass = kEllThreads / group;
  const int64_t slice = (k + group - 1) / group;
  const int64_t my_lo = min(k, (int64_t)g * slice), my_hi = min(k, my_lo + slice);
  const int64_t n_tiles = (n + tile_rows - 1) / tile_rows;
  const int64_t tile_entries = (int64_t)tile_rows * k;
  const int64_t n_chunks = tile_entries > stage ? (tile_entries + stage - 1) / stage : 1;
  const int64_t my_tiles = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int64_t units = my_tiles * n_chunks;

  // unit u: its tile's first row and rows, and its entries [c0, c1)
  auto unit = [&](int64_t u, int64_t& row0, int& rows, int64_t& c0, int64_t& c1) {
    const int64_t tile = blockIdx.x + (u / n_chunks) * gridDim.x;
    row0 = tile * tile_rows;
    rows = (int)min((int64_t)tile_rows, n - row0);
    c0 = row0 * k + (u % n_chunks) * stage;
    c1 = min((row0 + rows) * k, c0 + stage);
  };

  if (tid == 0) {
    mbar_init(&s_full[0], 1);
    mbar_init(&s_full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int64_t row0, c0, c1;
  int rows;
  if (units > 0) {
    unit(0, row0, rows, c0, c1);
    load_entries(smem, stage, idx, val, c0, c1, &s_full[0]);
  }
  __syncthreads();

  Acc acc = Acc(0);
  for (int64_t u = 0; u < units; ++u) {
    // the next unit's runs go into the other stage, freed by the
    // __syncthreads() that ended the unit before this one
    if (u + 1 < units) {
      unit(u + 1, row0, rows, c0, c1);
      load_entries(smem + ((u + 1) & 1) * stage_bytes, stage, idx, val, c0, c1,
                   &s_full[(u + 1) & 1]);
    }
    unit(u, row0, rows, c0, c1);
    mbar_wait(&s_full[u & 1], (uint32_t)((u >> 1) & 1));
    unsigned char* st = smem + (u & 1) * stage_bytes;
    const int32_t* s_idx = reinterpret_cast<const int32_t*>(
        st + ((uintptr_t)(idx + c0) & 15u));
    const V* s_val = reinterpret_cast<const V*>(
        st + (int64_t)stage * 4 + 16 + ((uintptr_t)(val + c0) & 15u));
    const int n_here = (int)(c1 - c0);
    const bool last = (u % n_chunks) == n_chunks - 1;
    const int passes = (rows + rows_per_pass - 1) / rows_per_pass;
    for (int p = 0; p < passes; ++p) {
      const int r = p * rows_per_pass + gid;
      if (r < rows) {
        const int64_t first = (row0 + r) * k - c0;   // the row's entry 0, in the stage
        acc = slice_sum(acc, s_idx, s_val, (int)max(first + my_lo, (int64_t)0),
                        (int)min(first + my_hi, (int64_t)n_here), w, dim);
      }
      if (last) {
        acc = group_sum(acc, group, s_warp);
        if (g == 0 && r < rows) z[row0 + r] = (T)acc;
        acc = Acc(0);
      }
    }
    __syncthreads();   // this stage is free; the next unit's ends are visible
  }
}

// The panel loop shared by the matvec over column panels (key: row in the
// tile, gathered: w by column in the panel) and the transpose over row
// panels (key: column in the tile, gathered: v by row in the panel): one
// block sums the segments off[0 .. n_panels) of its tile, local panel q
// being panel p_base + q of the gathered vector x (x_len entries), into
// s_acc[key] (acc_len accumulators, zeroed by the caller). The caller has
// initialised s_full's two barriers, loaded `off` into shared memory and
// synchronised; on return every panel is summed and added, in panel order,
// and the block must synchronise before it reads s_acc. SQUARE squares
// each value after its upcast (the Hessian diagonal's val^2). With DIRECT, a
// segment of fewer than kStageMin entries gathers x straight from device
// memory (its few sectors, held in L2) and its panel is not staged (the
// transpose's tiles of few columns; the matvec's segments are all staged:
// its tiles hold thousands of rows). `j` is the ring's
// position, the staged panels the block has summed before this call (stage
// j & 1, barrier phase (j >> 1) & 1); returns it advanced.
template <typename V, typename T, bool SQUARE, bool DIRECT>
__device__ __forceinline__ int panel_sum(const uint32_t* __restrict__ codes,
                                         const V* __restrict__ vals, const int64_t* off,
                                         int n_panels, int p_base,
                                         const T* __restrict__ x, int64_t x_len, T* s_x,
                                         Acc* s_acc, int acc_len, uint64_t* s_full,
                                         Acc* s_scan, Acc* s_wsum, int* s_wkey, int j) {
  constexpr int kCols = kPanelBytes / (int)sizeof(T);
  const int tid = threadIdx.x;

  // p: the panel being summed (in stage j & 1 where staged); ahead: the
  // last staged panel asked for.
  const int min_staged = DIRECT ? kStageMin : 1;
  int p = next_panel(off, -1, n_panels);
  int ahead = DIRECT ? next_staged(off, -1, n_panels, min_staged) : p;
  if (ahead < n_panels) {
    load_panel(s_x + (j & 1) * kCols, x, x_len, p_base + ahead, &s_full[j & 1]);
    const int q = next_staged(off, ahead, n_panels, min_staged);
    if (q < n_panels) {
      load_panel(s_x + ((j + 1) & 1) * kCols, x, x_len, p_base + q, &s_full[(j + 1) & 1]);
      ahead = q;
    }
  }
  __syncthreads();

  // A key's panel partial goes into its accumulator once; skip entries
  // (kPadKey) and the "no key yet" -1 emit nothing.
  auto emit = [&](int key, Acc value) {
    if ((unsigned)key < (unsigned)acc_len) s_acc[key] += value;
  };

  if (p < n_panels) {
    int64_t s0 = off[p], s1 = off[p + 1], pos = s0;   // segment, chunk start
    const int64_t tile_end = off[n_panels];
    int64_t fetched = pos;   // thread 0: entries asked of L2 so far
    PanelChunk<V> chunk;
    load_chunk(chunk, codes, vals, pos, (int)min((int64_t)kPanelChunk, s1 - pos));
    bool staged = !DIRECT || s1 - s0 >= kStageMin;
    if (staged) mbar_wait(&s_full[j & 1], (j >> 1) & 1);
    for (;;) {
      const int n = (int)min((int64_t)kPanelChunk, s1 - pos);
      const bool last = pos + n == s1;
      int p2 = p;
      int64_t pos2 = pos + n, s0_2 = s0, s1_2 = s1;
      if (last) {
        p2 = next_panel(off, p, n_panels);
        if (p2 < n_panels) {
          s0_2 = pos2 = off[p2];
          s1_2 = off[p2 + 1];
        }
      }
      // Walk this thread's entries; the key starts at the entry before
      // them (the previous thread's last key), -1 at a segment's start.
      const int d = tid * kPanelItems;
      int key = (pos + min(d, n) - 1 >= s0) ? (int)(chunk.prev >> kCodeShift) : -1;
      const int first_key = key;
      SegmentWalk walk;
      if (tid == 0 && pos > s0) walk.run = s_scan[kPanelThreads - 1];   // carry
      auto walk_items = [&](auto gather) {
#pragma unroll
        for (int k = 0; k < kPanelItems; ++k) {
          if (d + k < n) {
            const uint32_t c = chunk.code[k];
            const int ck = (int)(c >> kCodeShift);
            if (ck != key) {
              walk.close(key, emit);
              key = ck;
            }
            if (ck != kPadKey) {
              Acc a = upcast(chunk.val[k]);
              if (SQUARE) a = __dmul_rn(a, a);   // after the upcast
              walk.run = walk.run + __dmul_rn(a, (Acc)gather(c & kIdxMask));
            }
          }
        }
      };
      if (!DIRECT || staged) {
        const T* xs = s_x + (j & 1) * kCols;
        walk_items([&](uint32_t i) { return xs[i]; });
      } else {
        const T* xg = x + (int64_t)(p_base + p) * kCols;
        walk_items([&](uint32_t i) { return __ldg(xg + i); });
      }
      // This chunk's entries are walked: load the next one into the same
      // registers, in flight during the scan.
      if (p2 < n_panels) {
        const int n2 = (int)min((int64_t)kPanelChunk, s1_2 - pos2);
        load_chunk(chunk, codes, vals, pos2, n2);
        // the tile's segments are contiguous: keep kPanelPrefetch chunks
        // of the stream beyond the register loads on their way into L2
        if (kPanelPrefetch > 0 && tid == 0) {
          const int64_t want = min(pos2 + n2 + (int64_t)kPanelPrefetch * kPanelChunk,
                                   tile_end);
          prefetch_entries(codes, vals, max(fetched, pos2 + n2), want);
          fetched = max(fetched, want);
        }
      }

      const Acc s = block_segmented_scan(walk.run, key, s_wsum, s_wkey, s_scan);
      if (walk.emitted) emit(first_key, walk.head_value(s_scan));
      if (last && tid == kPanelThreads - 1) emit(key, s);   // the open key

      if (last) {
        __syncthreads();   // panel p summed: its stage, if any, is free
        if constexpr (DIRECT) {
          if (staged) {
            const int p3 = next_staged(off, ahead, n_panels, kStageMin);
            if (p3 < n_panels) {
              load_panel(s_x + (j & 1) * kCols, x, x_len, p_base + p3, &s_full[j & 1]);
              ahead = p3;
            }
            ++j;
          }
        } else {
          // every non-empty panel is staged: the one after p2 goes into p's
          const int p3 = p2 < n_panels ? next_panel(off, p2, n_panels) : n_panels;
          if (p3 < n_panels) {
            load_panel(s_x + (j & 1) * kCols, x, x_len, p_base + p3, &s_full[j & 1]);
          }
          ++j;
        }
        if (p2 >= n_panels) break;
        staged = !DIRECT || s1_2 - s0_2 >= kStageMin;
        if (staged) mbar_wait(&s_full[j & 1], (j >> 1) & 1);
      }
      p = p2;
      pos = pos2;
      s0 = s0_2;
      s1 = s1_2;
    }
  }
  return j;
}

// One block per row tile; see "The matvec over column panels" above.
// offsets[tile, p] .. offsets[tile, p + 1] is segment (tile, p).
template <typename V, typename T>
__global__ void __launch_bounds__(kPanelThreads, 1)
ell_panel_kernel(const uint32_t* __restrict__ codes, const V* __restrict__ vals,
                 const int64_t* __restrict__ offsets, const T* __restrict__ w,
                 T* __restrict__ z, int64_t n_rows, int64_t dim, int tile_rows,
                 int n_panels) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* s_w = reinterpret_cast<T*>(smem);                           // [2][kCols]
  Acc* s_acc = reinterpret_cast<Acc*>(smem + 2 * kPanelBytes);   // [tile_rows]
  int64_t* off = reinterpret_cast<int64_t*>(s_acc + tile_rows);  // [n_panels+1]
  __shared__ __align__(8) uint64_t s_full[2];
  __shared__ Acc s_scan[kPanelThreads];
  __shared__ Acc s_wsum[kPanelWarps];
  __shared__ int s_wkey[kPanelWarps];

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * tile_rows;
  const int rows = (int)min((int64_t)tile_rows, n_rows - row0);

  if (tid == 0) {
    mbar_init(&s_full[0], 1);
    mbar_init(&s_full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int r = tid; r < tile_rows; r += kPanelThreads) s_acc[r] = Acc(0);
  // the tile's segment offsets, read at every chunk: kept in shared memory
  for (int q = tid; q <= n_panels; q += kPanelThreads) {
    off[q] = offsets[(int64_t)blockIdx.x * (n_panels + 1) + q];
  }
  __syncthreads();
  panel_sum<V, T, false, false>(codes, vals, off, n_panels, 0, w, dim, s_w, s_acc,
                                tile_rows, s_full, s_scan, s_wsum, s_wkey, 0);
  __syncthreads();
  for (int r = tid; r < rows; r += kPanelThreads) z[row0 + r] = (T)s_acc[r];
}

// Persistent blocks over the row-panel transpose layout's bands; see "The
// transpose over row panels" above. Block b takes bands starts[b] ..
// starts[b + 1] - 1 in order; bands[i] = (tile, first panel, end panel,
// slot): the block sums segments (tile, first .. end - 1) and writes g for
// the tile's columns, or (slot >= 0, a tile cut into several bands) its
// float64 partials to row `slot` of `partials` for csc_band_fixup_kernel.
template <typename V, bool SQUARE>
__global__ void __launch_bounds__(kPanelThreads, 1)
csc_panel_kernel(const uint32_t* __restrict__ codes, const V* __restrict__ vals,
                 const int64_t* __restrict__ offsets, const int64_t* __restrict__ bands,
                 const int64_t* __restrict__ starts, const float* __restrict__ v,
                 float* __restrict__ g, double* __restrict__ partials, int64_t n_rows,
                 int64_t dim, int tile_cols, int n_panels) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_v = reinterpret_cast<float*>(smem);                   // [2][kRows]
  Acc* s_acc = reinterpret_cast<Acc*>(smem + 2 * kPanelBytes);   // [tile_cols]
  int64_t* off = reinterpret_cast<int64_t*>(s_acc + tile_cols);  // [band panels+1]
  __shared__ __align__(8) uint64_t s_full[2];
  __shared__ Acc s_scan[kPanelThreads];
  __shared__ Acc s_wsum[kPanelWarps];
  __shared__ int s_wkey[kPanelWarps];

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&s_full[0], 1);
    mbar_init(&s_full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int j = 0;   // the ring's position, carried from band to band
  for (int64_t i = starts[blockIdx.x]; i < starts[blockIdx.x + 1]; ++i) {
    const int64_t* band = bands + 4 * i;
    const int64_t tile = band[0], slot = band[3];
    const int p_lo = (int)band[1], n_local = (int)(band[2] - band[1]);
    const int64_t col0 = tile * tile_cols;
    const int cols = (int)min((int64_t)tile_cols, dim - col0);
    // each thread zeroes the accumulators it flushed for the last band
    for (int c = tid; c < tile_cols; c += kPanelThreads) s_acc[c] = Acc(0);
    for (int q = tid; q <= n_local; q += kPanelThreads) {
      off[q] = offsets[tile * (n_panels + 1) + p_lo + q];
    }
    __syncthreads();
    j = panel_sum<V, float, SQUARE, true>(codes, vals, off, n_local, p_lo, v, n_rows, s_v,
                                          s_acc, tile_cols, s_full, s_scan, s_wsum, s_wkey,
                                          j);
    __syncthreads();
    if (slot < 0) {
      for (int c = tid; c < cols; c += kPanelThreads) g[col0 + c] = (float)s_acc[c];
    } else {
      double* out = partials + slot * tile_cols;
      for (int c = tid; c < cols; c += kPanelThreads) out[c] = s_acc[c];
    }
  }
}

// Finish the columns of the tiles cut into bands: fixups[q] = (tile, first
// slot, bands); each column sums its bands' partials in panel order, in
// double, and rounds once.
__global__ void __launch_bounds__(kThreads)
csc_band_fixup_kernel(const int64_t* __restrict__ fixups, int64_t n_fixups,
                      const double* __restrict__ partials, float* __restrict__ g,
                      int64_t dim, int tile_cols) {
  const int64_t total = n_fixups * tile_cols;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int64_t q = i / tile_cols, c = i % tile_cols;
    const int64_t tile = fixups[3 * q], first = fixups[3 * q + 1], nb = fixups[3 * q + 2];
    const int64_t col = tile * tile_cols + c;
    if (col >= dim) continue;
    Acc acc = Acc(0);
    for (int64_t b = 0; b < nb; ++b) acc += partials[(first + b) * tile_cols + c];
    g[col] = (float)acc;
  }
}

template <typename V, typename T, bool SQUARE>
__global__ void __launch_bounds__(kCscThreads, kCscMinBlocks)
csc_tile_kernel(const int64_t* __restrict__ colptr,
                const int32_t* __restrict__ rows, const V* __restrict__ vals,
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
  V x[kCscItemsPerThread];
  T vr[kCscItemsPerThread];
#pragma unroll
  for (int k = 0; k < kCscItemsPerThread; ++k) {
    const int e = tid + k * kCscThreads;
    r[k] = -1;
    x[k] = vzero<V>();
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
      Acc a = upcast(x[k]);
      if (SQUARE) a = a * a;   // after the upcast
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
  SegmentWalk walk;
  auto write = [&](int c, Acc value) { g[i0 + c] = (T)value; };
  for (int item = d; item < d_end; ++item) {
    const int end = col < nc ? s_ends[col] : INT_MAX;
    if (y < end) {
      walk.run += s_prod[y];
      ++y;
    } else {
      walk.close(col, write);
      ++col;
    }
  }

  // 3. Segmented inclusive scan of the open-column partials (key: column).
  const Acc s = block_segmented_scan(walk.run, col, s_wsum, s_wkey, s_scan);

  // The thread before this one ended on this thread's first column.
  if (walk.emitted) {
    const Acc value = walk.head_value(s_scan);
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

// Shared memory of the row-tile matvec: two stages of `stage` entries.
template <typename V>
int64_t ell_smem_bytes(int64_t stage) {
  return 2 * (stage * (4 + (int64_t)sizeof(V)) + 32);
}

template <typename V, typename T>
int launch_matvec(const void* idx, const void* val, const void* w, void* z,
                  int64_t n, int64_t k, int64_t dim, int64_t tile_rows,
                  int64_t group, int64_t stage, void* stream) {
  if (n < 1 || k < 0 || dim < 0 || group < 1 || group > kEllThreads ||
      (group & (group - 1)) != 0 || stage < 4 || stage % 4 != 0 ||
      stage > (1 << 20) || tile_rows < 1 || tile_rows > INT_MAX ||
      (tile_rows > 1 && tile_rows * k > stage)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = (int)ell_smem_bytes<V>(stage);
  // The shared-memory attribute and the resident blocks of the card, set and
  // asked once per device and stage size: both cost more host time than a
  // small launch.
  static int cached_device = -1, cached_smem = -1;
  static int64_t cached_blocks = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != cached_device || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(ell_matvec_kernel<V, T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, ell_matvec_kernel<V, T>, kEllThreads, smem)) != cudaSuccess) {
      return (int)err;
    }
    cached_blocks = (int64_t)max(per_sm, 1) * sms;
    cached_device = device;
    cached_smem = smem;
  }
  const int64_t n_tiles = (n + tile_rows - 1) / tile_rows;
  const int64_t blocks = min(n_tiles, cached_blocks);
  ell_matvec_kernel<V, T><<<(unsigned)blocks, kEllThreads, (size_t)smem,
                            (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const V*)val, (const T*)w, (T*)z, n, k, dim,
      (int)tile_rows, (int)group, (int)stage);
  return (int)cudaGetLastError();
}

template <typename V, typename T>
int launch_panel_matvec(const void* codes, const void* vals, const void* offsets,
                        const void* w, void* z, int64_t n_rows, int64_t dim,
                        int64_t tile_rows, int64_t n_tiles, int64_t n_panels,
                        int64_t panel_cols, void* stream) {
  constexpr int64_t kCols = kPanelBytes / (int64_t)sizeof(T);
  if (panel_cols != kCols || tile_rows < 1 || tile_rows > kMaxTileRows ||
      n_tiles < 1 || n_tiles > INT_MAX || n_panels < 0 ||
      n_panels != (dim + kCols - 1) / kCols || (n_tiles - 1) * tile_rows >= n_rows ||
      n_tiles * tile_rows < n_rows ||
      ((uintptr_t)codes | (uintptr_t)vals | (uintptr_t)w) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t smem = 2 * kPanelBytes + tile_rows * (int64_t)sizeof(Acc) +
                       (n_panels + 1) * (int64_t)sizeof(int64_t);
  if (smem > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ell_panel_kernel<V, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ell_panel_kernel<V, T><<<(unsigned)n_tiles, kPanelThreads, (size_t)smem,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)codes, (const V*)vals, (const int64_t*)offsets,
      (const T*)w, (T*)z, n_rows, dim, (int)tile_rows, (int)n_panels);
  return (int)cudaGetLastError();
}

template <typename V, bool SQUARE>
int launch_panel_rmatvec(const void* codes, const void* vals, const void* offsets,
                         const void* bands, const void* starts, const void* fixups,
                         const void* v, void* g, void* partials, int64_t n_rows,
                         int64_t dim, int64_t tile_cols, int64_t n_tiles, int64_t n_panels,
                         int64_t panel_rows, int64_t n_bands, int64_t n_blocks,
                         int64_t n_fixups, int64_t max_band_panels, void* stream) {
  constexpr int64_t kRows = kPanelBytes / (int64_t)sizeof(float);
  if (panel_rows != kRows || n_rows < 1 || dim < 1 || tile_cols < 1 ||
      tile_cols > kMaxTileCols || n_tiles != (dim + tile_cols - 1) / tile_cols ||
      n_panels != (n_rows + kRows - 1) / kRows || n_bands < n_tiles || n_blocks < 1 ||
      n_blocks > INT_MAX || n_fixups < 0 || n_fixups > n_tiles || max_band_panels < 0 ||
      max_band_panels > n_panels ||
      ((uintptr_t)codes | (uintptr_t)vals | (uintptr_t)v) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t smem = 2 * kPanelBytes + tile_cols * (int64_t)sizeof(Acc) +
                       (max_band_panels + 1) * (int64_t)sizeof(int64_t);
  if (smem > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      csc_panel_kernel<V, SQUARE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  csc_panel_kernel<V, SQUARE><<<(unsigned)n_blocks, kPanelThreads, (size_t)smem, st>>>(
      (const uint32_t*)codes, (const V*)vals, (const int64_t*)offsets,
      (const int64_t*)bands, (const int64_t*)starts, (const float*)v, (float*)g,
      (double*)partials, n_rows, dim, (int)tile_cols, (int)n_panels);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_fixups == 0) return (int)err;
  csc_band_fixup_kernel<<<(unsigned)blocks_for((n_fixups * tile_cols + kWarp - 1) / kWarp),
                          kThreads, 0, st>>>((const int64_t*)fixups, n_fixups,
                                             (const double*)partials, (float*)g, dim,
                                             (int)tile_cols);
  return (int)cudaGetLastError();
}

template <typename V, typename T, bool SQUARE>
int launch_rmatvec(const void* colptr, const void* rows, const void* vals,
                   const void* v, const void* tiles, const void* splits,
                   void* partials, void* g, int64_t n_tiles, int64_t n_splits,
                   int64_t n_rows, int64_t tile_items, void* stream) {
  if (tile_items != kTileItems || n_tiles < 1 || n_tiles > INT_MAX ||
      n_splits < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  csc_tile_kernel<V, T, SQUARE><<<(unsigned)n_tiles, kCscThreads, 0, st>>>(
      (const int64_t*)colptr, (const int32_t*)rows, (const V*)vals,
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
                   int64_t n, int64_t k, int64_t dim, int64_t tile_rows,
                   int64_t group, int64_t stage, void* stream) {
  return launch_matvec<float, float>(idx, val, w, z, n, k, dim, tile_rows, group, stage,
                              stream);
}

int ell_matvec_f64(const void* idx, const void* val, const void* w, void* z,
                   int64_t n, int64_t k, int64_t dim, int64_t tile_rows,
                   int64_t group, int64_t stage, void* stream) {
  return launch_matvec<double, double>(idx, val, w, z, n, k, dim, tile_rows, group, stage,
                               stream);
}

int ell_panel_matvec_f32(const void* codes, const void* vals,
    const void* offsets, const void* w, void* z, int64_t n_rows, int64_t dim,
    int64_t tile_rows, int64_t n_tiles, int64_t n_panels, int64_t panel_cols,
    void* stream) {
  return launch_panel_matvec<float, float>(codes, vals, offsets, w, z, n_rows, dim,
      tile_rows, n_tiles, n_panels, panel_cols, stream);
}

int ell_panel_matvec_f64(const void* codes, const void* vals,
    const void* offsets, const void* w, void* z, int64_t n_rows, int64_t dim,
    int64_t tile_rows, int64_t n_tiles, int64_t n_panels, int64_t panel_cols,
    void* stream) {
  return launch_panel_matvec<double, double>(codes, vals, offsets, w, z, n_rows, dim,
      tile_rows, n_tiles, n_panels, panel_cols, stream);
}

int csc_rmatvec_f32(const void* colptr, const void* rows, const void* vals,
    const void* v, const void* tiles, const void* splits, void* partials,
    void* g, int64_t n_tiles, int64_t n_splits, int64_t n_rows,
    int64_t tile_items, void* stream) {
  return launch_rmatvec<float, float, false>(colptr, rows, vals, v, tiles, splits,
      partials, g, n_tiles, n_splits, n_rows, tile_items, stream);
}

int csc_rmatvec_f64(const void* colptr, const void* rows, const void* vals,
    const void* v, const void* tiles, const void* splits, void* partials,
    void* g, int64_t n_tiles, int64_t n_splits, int64_t n_rows,
    int64_t tile_items, void* stream) {
  return launch_rmatvec<double, double, false>(colptr, rows, vals, v, tiles, splits,
      partials, g, n_tiles, n_splits, n_rows, tile_items, stream);
}

int csc_sq_rmatvec_f32(const void* colptr, const void* rows, const void* vals,
    const void* v, const void* tiles, const void* splits, void* partials,
    void* g, int64_t n_tiles, int64_t n_splits, int64_t n_rows,
    int64_t tile_items, void* stream) {
  return launch_rmatvec<float, float, true>(colptr, rows, vals, v, tiles, splits,
      partials, g, n_tiles, n_splits, n_rows, tile_items, stream);
}

int csc_sq_rmatvec_f64(const void* colptr, const void* rows, const void* vals,
    const void* v, const void* tiles, const void* splits, void* partials,
    void* g, int64_t n_tiles, int64_t n_splits, int64_t n_rows,
    int64_t tile_items, void* stream) {
  return launch_rmatvec<double, double, true>(colptr, rows, vals, v, tiles, splits,
      partials, g, n_tiles, n_splits, n_rows, tile_items, stream);
}

// bfloat16 values, float vector and result: the four kernels reading values
// stored as bf16 (upcast on load), each bit-equal to its f32 form run on the
// upcast values.
int ell_matvec_bf16(const void* idx, const void* val, const void* w, void* z,
                    int64_t n, int64_t k, int64_t dim, int64_t tile_rows,
                    int64_t group, int64_t stage, void* stream) {
  return launch_matvec<Bf16, float>(idx, val, w, z, n, k, dim, tile_rows, group,
                                    stage, stream);
}

int ell_panel_matvec_bf16(const void* codes, const void* vals,
    const void* offsets, const void* w, void* z, int64_t n_rows, int64_t dim,
    int64_t tile_rows, int64_t n_tiles, int64_t n_panels, int64_t panel_cols,
    void* stream) {
  return launch_panel_matvec<Bf16, float>(codes, vals, offsets, w, z, n_rows, dim,
      tile_rows, n_tiles, n_panels, panel_cols, stream);
}

int csc_rmatvec_bf16(const void* colptr, const void* rows, const void* vals,
    const void* v, const void* tiles, const void* splits, void* partials,
    void* g, int64_t n_tiles, int64_t n_splits, int64_t n_rows,
    int64_t tile_items, void* stream) {
  return launch_rmatvec<Bf16, float, false>(colptr, rows, vals, v, tiles, splits,
      partials, g, n_tiles, n_splits, n_rows, tile_items, stream);
}

int csc_sq_rmatvec_bf16(const void* colptr, const void* rows, const void* vals,
    const void* v, const void* tiles, const void* splits, void* partials,
    void* g, int64_t n_tiles, int64_t n_splits, int64_t n_rows,
    int64_t tile_items, void* stream) {
  return launch_rmatvec<Bf16, float, true>(colptr, rows, vals, v, tiles, splits,
      partials, g, n_tiles, n_splits, n_rows, tile_items, stream);
}

// The transpose over row panels (csc_panel_kernel): bfloat16 values, the
// bf16 transposes' route where transpose_panels_pay_off sends a layout,
// and float values, their bit-for-bit witness on the upcast values.
#define PANEL_RMATVEC_ENTRY(NAME, V, SQ)                                                  \
  int NAME(const void* codes, const void* vals, const void* offsets, const void* bands, \
           const void* starts, const void* fixups, const void* v, void* g,               \
           void* partials, int64_t n_rows, int64_t dim, int64_t tile_cols,                \
           int64_t n_tiles, int64_t n_panels, int64_t panel_rows, int64_t n_bands,       \
           int64_t n_blocks, int64_t n_fixups, int64_t max_band_panels, void* stream) {  \
    return launch_panel_rmatvec<V, SQ>(codes, vals, offsets, bands, starts, fixups, v,   \
                                       g, partials, n_rows, dim, tile_cols, n_tiles,      \
                                       n_panels, panel_rows, n_bands, n_blocks,          \
                                       n_fixups, max_band_panels, stream);               \
  }

PANEL_RMATVEC_ENTRY(csc_panel_rmatvec_f32, float, false)
PANEL_RMATVEC_ENTRY(csc_sq_panel_rmatvec_f32, float, true)
PANEL_RMATVEC_ENTRY(csc_panel_rmatvec_bf16, Bf16, false)
PANEL_RMATVEC_ENTRY(csc_sq_panel_rmatvec_bf16, Bf16, true)

const char* ell_sparse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
