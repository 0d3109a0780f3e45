// quack_scan.cu: stake-weighted QUACK and loss quorums plus the contiguous
// quacked prefix, written for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/quack_scan.py::quack_scan
// (_kernel, _kernel_no_lost, _prefix_scan). For B independent lanes (one
// simulated link each), claims and complaints (B, S, R, W) bool (one byte
// per entry), stakes (B, R) f32 and two (B,) f32 thresholds it computes
//
//   quacked[b,s,w] = sum_r stakes[b,r] * claims[b,s,r,w]     >= qthr[b]
//   lost[b,s,w]    = sum_r stakes[b,r] * complaints[b,s,r,w] >= dthr[b]
//                    && !quacked[b,s,w]
//   prefix[b,s]    = length of the leading run of quacked columns of (b, s)
//
// The TPU kernel's (S, R, W) form is the B = 1 case of the same launch.
//
// What bounds it: device-memory bytes. Every bitmap byte is read once and
// feeds one f32 add, far below the card's operations-per-byte balance. At
// the dense main-path shape (B = 1, S = R = 19, W = 65,536) one launch
// with the loss quorum reads 47.3 MB and writes 2.5 MB, about 14.9 us at
// 3.35 TB/s; without it, 24.9 MB, about 7.4 us. At the windowed engine's
// width (W = 6,016) the same launch moves 4.6 MB, 1.4 us: there the bytes
// have to be in flight at once, or the kernel waits on load latency. Every
// protocol round launches it twice, once with and once without the loss
// quorum; the windowed engine once more per rotating chunk, for its GC
// frontier.
//
// Design (the host's plan is kernels/quack_scan.py::plan_quack_launch):
// * Grid (C, S, B), one thread-block cluster of C <= 8 CTAs per (b, s)
//   row. CTA k of the cluster owns columns [k * cols, (k + 1) * cols) of
//   the row and walks them in tiles. At W = 6,016 that is 8 CTAs of 752
//   columns a row, 152 CTAs for S = 19 (the grid of one CTA per 4,096
//   columns had 38).
// * Staging (kStaged, every launch with the loss quorum and the narrow
//   ones without): one warp fills a stage with one cp.async.bulk copy per
//   replica row and bitmap (the row's tile is contiguous in memory), the
//   claims completing on one mbarrier and the complaints on another, so
//   the claims are summed while the complaints arrive; a thread sums 4
//   columns. At W = 6,016 a CTA's whole slab is one stage, in flight at
//   once; up to 4 stages rotate when a CTA has several tiles (densely 8
//   tiles of 1,024 columns in two stages), the stage just consumed being
//   refilled after the CTA's one barrier a tile.
// * Wide rows without the loss quorum (kVector, from 2,048 columns a
//   CTA): a thread reads its 16 columns of each row with one 16-byte
//   load, 8 rows in flight; there it beat staging on the card
//   (chip_smoke.py's plan evidence; PERF.md).
// * kBytes: byte loads, masked, where W or a pointer is off 16 bytes or R
//   is too large to stage a tile.
// * Sum order: each column's sum stays in one thread, r ascending, in f32,
//   from 0. claims are 0/1, so each term is the stake or 0 exactly; the
//   kernel adds the stake where the byte is 1 and skips the add where it
//   is 0, which equals adding stake * 0. The plain torch version
//   (ref.py::_weigh) sums in the same order, so the two agree bit for bit
//   for any stakes. R is never split across threads: partial sums would
//   round otherwise.
// * Prefix without atomics or a fill: each CTA takes the min of its
//   threads' first unquacked columns (warp __reduce_min_sync, then shared
//   memory) and writes it into rank 0's shared memory with st.async,
//   whose 4 bytes complete on an mbarrier there (distributed shared
//   memory, after a cluster barrier that every CTA arrived at when it
//   started, so the mbarrier is initialised); rank 0 waits on it and
//   stores the min, W if none, into prefix[b, s] with a plain store. The
//   TPU kernel carried the prefix across its sequential grid; here the
//   cluster covers the row.
// * Each CTA stages its own lane's stakes in shared memory and reads the
//   thresholds through device pointers, so a run never syncs the host for
//   them. The compute_lost = false variant never touches the complaints.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro_torch::bulk_load;
using repro_torch::mbar_expect_tx;
using repro_torch::mbar_fence_init;
using repro_torch::mbar_init;
using repro_torch::mbar_wait;
using repro_torch::smem_u32;

// The three ways to read the bitmaps (see the design notes above).
enum Path : int { kBytes = 0, kVector = 1, kStaged = 2 };

__host__ __device__ constexpr int cols_a_thread(int path) { return path == kVector ? 16 : 4; }

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 200 * 1024;  // dynamic shared memory a CTA may ask for
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of `p` in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}
// Stores v at a cluster shared-memory address, counting its 4 bytes on the
// mbarrier at `bar` (in the same CTA's memory); no fence is needed.
__device__ __forceinline__ void st_async(uint32_t addr, int v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(v), "r"(bar)
               : "memory");
}

// One row's bytes of a thread's N columns, as N / 4 words: from shared
// memory (kStaged), one 16-byte load (kVector), or the nv columns in range
// byte by byte (kBytes).
template <int PATH, int N>
__device__ __forceinline__ void load_row(const uint8_t* row, int nv, uint32_t (&w)[N / 4]) {
  if constexpr (PATH == kStaged) {
    w[0] = *reinterpret_cast<const uint32_t*>(row);
  } else if constexpr (PATH == kVector) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    w[0] = 0;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < nv) w[0] |= static_cast<uint32_t>(__ldg(row + i)) << (8 * i);
  }
}

// Stake sums of a thread's N columns over R rows `stride` bytes apart, r
// ascending from 0. A claim byte is 0 or 1: the stake is added where it is
// 1 (a predicated add, which equals adding stake * 0 = +-0 where it is 0).
template <int PATH, int N>
__device__ __forceinline__ void weigh(const uint8_t* p, size_t stride, int R, int nv,
                                      const float* stakes, float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
#pragma unroll 8
  for (int r = 0; r < R; ++r) {
    uint32_t w[N / 4];
    load_row<PATH, N>(p + r * stride, nv, w);
    const float st = stakes[r];
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (w[i / 4] & (0xffu << (8 * (i % 4)))) acc[i] += st;
  }
}

// N output bytes packed in N / 4 words: one aligned store, or nv bytes.
template <int PATH, int N>
__device__ __forceinline__ void store_cols(uint8_t* p, const uint32_t (&w)[N / 4], int nv) {
  if constexpr (PATH == kStaged) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else if constexpr (PATH == kVector) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < nv) p[i] = static_cast<uint8_t>(w[0] >> (8 * i));
  }
}

// Dynamic shared memory: 2 mbarriers a stage (claims, complaints) in 16
// bytes, the lane's stakes (R floats, padded to 16 bytes), then `stages`
// stages of (LOST ? 2 : 1) x R rows of `tile` bytes (kStaged only).
// Outside kStaged, stages = 0 and a tile is the block's columns, kCols a
// thread.
template <bool LOST, int PATH>
__global__ void __launch_bounds__(kMaxThreads)
quack_scan_kernel(const uint8_t* __restrict__ claims,
                  const uint8_t* __restrict__ complaints,
                  const float* __restrict__ stakes,
                  const float* __restrict__ qthr,
                  const float* __restrict__ dthr,
                  uint8_t* __restrict__ quacked, uint8_t* __restrict__ lost,
                  int* __restrict__ prefix, int R, int W, int cols, int tile,
                  int stages) {
  constexpr bool kStage = PATH == kStaged;
  constexpr int kCols = cols_a_thread(PATH);
  constexpr int kWords = kCols / 4;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_warp_first[kMaxThreads / 32];
  // rank 0's: each CTA's first unquacked column, and the mbarrier on
  // which their stores complete
  __shared__ int s_cta_first[kMaxCluster];
  __shared__ __align__(8) uint64_t s_first_bar;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (rank == 0 && tid == 0) {
    mbar_init(smem_u32(&s_first_bar), 1);
    mbar_fence_init();
    mbar_expect_tx(smem_u32(&s_first_bar), 4 * cluster.num_blocks());
  }
  cluster_arrive_relaxed();  // waited on before rank 0's memory is written

  const int b = blockIdx.z;
  const size_t bs = static_cast<size_t>(b) * gridDim.y + blockIdx.y;  // (b, s)
  const int begin = rank * cols;
  const int n_cols = max(0, min(W - begin, cols));
  const int n_tiles = (n_cols + tile - 1) / tile;
  constexpr int kMaps = LOST ? 2 : 1;

  const uint32_t bars = smem_u32(smem);
  float* s_stakes = reinterpret_cast<float*>(smem + 16 * stages);
  uint8_t* rows = smem + 16 * stages + ((4 * R + 15) & ~15);
  const uint32_t stage_bytes = kMaps * R * tile;
  const uint8_t* c_slab = claims + bs * R * W + begin;
  const uint8_t* x_slab = LOST ? complaints + bs * R * W + begin : nullptr;

  // warp 0 fills stage t % stages with tile t: one bulk copy per row
  auto fill = [&](int t) {
    const int s = t % stages;
    const uint32_t n = min(tile, n_cols - t * tile);
    const uint32_t bar = bars + 16 * s;
    const uint32_t dst = smem_u32(rows) + s * stage_bytes;
    if (lane == 0) {
      mbar_expect_tx(bar, R * n);
      if constexpr (LOST) mbar_expect_tx(bar + 8, R * n);
    }
    __syncwarp();
    for (int r = lane; r < R; r += 32) {
      const size_t at = static_cast<size_t>(r) * W + t * tile;
      bulk_load(dst + r * tile, c_slab + at, n, bar);
      if constexpr (LOST) bulk_load(dst + (R + r) * tile, x_slab + at, n, bar + 8);
    }
  };
  if constexpr (kStage) {
    if (warp == 0) {
      if (lane == 0) {
        for (int i = 0; i < 2 * stages; ++i) mbar_init(bars + 8 * i, 1);
        mbar_fence_init();
      }
      __syncwarp();
      for (int t = 0; t < min(stages, n_tiles); ++t) fill(t);
    }
  }
  for (int r = tid; r < R; r += blockDim.x) s_stakes[r] = stakes[static_cast<size_t>(b) * R + r];
  const float q = __ldg(qthr + b);
  const float d = LOST ? __ldg(dthr + b) : 0.0f;
  __syncthreads();

  const int j = tid * kCols;                // the thread's offset in a tile
  const size_t out_row = bs * W + begin;
  int first = W;                            // first unquacked column; W = none
  for (int t = 0; t < n_tiles; ++t) {
    const int n = min(tile, n_cols - t * tile);
    const int nv = min(kCols, n - j);       // the thread's columns in range
    const int at = t * tile + j;            // their offset in the CTA's columns
    const uint8_t* src_c = c_slab + at;
    const uint8_t* src_x = LOST ? x_slab + at : nullptr;
    size_t stride = W;
    int parity = 0;
    uint32_t bar = 0;
    if constexpr (kStage) {
      const int s = t % stages;
      src_c = rows + s * stage_bytes + j;
      src_x = src_c + R * tile;
      stride = tile;
      bar = bars + 16 * s;
      parity = (t / stages) & 1;
      mbar_wait(bar, parity);
    }
    float acc[kCols];
    uint32_t qk[kWords] = {};
    if (nv > 0) {
      weigh<PATH, kCols>(src_c, stride, R, nv, s_stakes, acc);
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const bool ok = acc[i] >= q;
        qk[i / 4] |= static_cast<uint32_t>(ok) << (8 * (i % 4));
        if (i < nv && !ok) first = min(first, begin + at + i);
      }
      store_cols<PATH, kCols>(quacked + out_row + at, qk, nv);
    }
    if constexpr (LOST) {
      if constexpr (kStage) mbar_wait(bar + 8, parity);
      if (nv > 0) {
        weigh<PATH, kCols>(src_x, stride, R, nv, s_stakes, acc);
        uint32_t lk[kWords] = {};
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const bool quack = (qk[i / 4] >> (8 * (i % 4))) & 1u;
          lk[i / 4] |= static_cast<uint32_t>(acc[i] >= d && !quack) << (8 * (i % 4));
        }
        store_cols<PATH, kCols>(lost + out_row + at, lk, nv);
      }
    }
    if constexpr (kStage) {
      __syncthreads();                      // every thread is done with the stage
      if (warp == 0 && t + stages < n_tiles) fill(t + stages);
    }
  }

  // The CTA's first unquacked column, then the cluster's on rank 0.
  const unsigned warp_first = __reduce_min_sync(0xffffffffu, static_cast<unsigned>(first));
  if (lane == 0) s_warp_first[warp] = static_cast<int>(warp_first);
  __syncthreads();
  cluster_wait();  // every CTA has started: rank 0's mbarrier is initialised
  if (tid == 0) {
    int m = W;
    for (int i = 0; i < static_cast<int>(blockDim.x) / 32; ++i) m = min(m, s_warp_first[i]);
    st_async(cluster_addr(&s_cta_first[rank], 0), m, cluster_addr(&s_first_bar, 0));
    if (rank == 0) {
      mbar_wait(smem_u32(&s_first_bar), 0);
      const int n_ranks = static_cast<int>(cluster.num_blocks());
      for (int i = 0; i < n_ranks; ++i) m = min(m, s_cta_first[i]);
      prefix[bs] = m;
    }
  }
}

template <bool LOST, int PATH>
cudaError_t launch(const uint8_t* claims, const uint8_t* complaints, const float* stakes,
                   const float* qthr, const float* dthr, uint8_t* quacked, uint8_t* lost,
                   int* prefix, int B, int S, int R, int W, int cluster, int cols, int tile,
                   int stages, int threads, int smem, cudaStream_t stream) {
  auto kern = quack_scan_kernel<LOST, PATH>;
  // once per device, so that no launch inside a graph capture sets it
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, S, B);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, claims, complaints, stakes, qthr, dthr, quacked, lost,
                           prefix, R, W, cols, tile, stages);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool LOST>
cudaError_t launch_path(int path, const uint8_t* c, const uint8_t* x, const float* st,
                        const float* q, const float* d, uint8_t* qo, uint8_t* lo, int* p,
                        int B, int S, int R, int W, int cluster, int cols, int tile, int stages,
                        int threads, int smem, cudaStream_t s) {
  switch (path) {
    case kStaged:
      return launch<LOST, kStaged>(c, x, st, q, d, qo, lo, p, B, S, R, W, cluster, cols, tile,
                                   stages, threads, smem, s);
    case kVector:
      return launch<LOST, kVector>(c, x, st, q, d, qo, lo, p, B, S, R, W, cluster, cols, tile,
                                   stages, threads, smem, s);
    default:
      return launch<LOST, kBytes>(c, x, st, q, d, qo, lo, p, B, S, R, W, cluster, cols, tile,
                                  stages, threads, smem, s);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Plain C entry point, loaded with ctypes. The launch plan (path, cluster
// size, columns a CTA, tile, stages, threads, dynamic shared memory) comes
// from kernels/quack_scan.py::plan_quack_launch: path 2 stages rows by bulk
// copies (stages > 0), path 1 reads 16 bytes a row a thread, path 0 a byte
// at a time; paths 1 and 2 need W and every bitmap pointer on 16-byte
// boundaries. prefix needs no initial value. Returns the CUDA error of the
// launch.
extern "C" int quack_scan_launch(const void* claims, const void* complaints,
                                 const void* stakes, const void* qthr,
                                 const void* dthr, void* quacked, void* lost,
                                 void* prefix, int B, int S, int R, int W,
                                 int compute_lost, int path, int cluster, int cols,
                                 int tile, int stages, int threads, int smem,
                                 void* stream) {
  if (path < kBytes || path > kStaged || cluster < 1 || cluster > kMaxCluster ||
      threads < 32 || threads > kMaxThreads || threads % 32 || tile < 1 ||
      tile > cols_a_thread(path) * threads || (path == kStaged) != (stages > 0) ||
      stages > kMaxStages || smem > kMaxSmem || static_cast<long long>(cluster) * cols < W)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* c = static_cast<const uint8_t*>(claims);
  const auto* x = static_cast<const uint8_t*>(complaints);
  const auto* st = static_cast<const float*>(stakes);
  const auto* q = static_cast<const float*>(qthr);
  const auto* d = static_cast<const float*>(dthr);
  auto* qo = static_cast<uint8_t*>(quacked);
  auto* lo = static_cast<uint8_t*>(lost);
  auto* p = static_cast<int*>(prefix);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      compute_lost ? launch_path<true>(path, c, x, st, q, d, qo, lo, p, B, S, R, W, cluster,
                                       cols, tile, stages, threads, smem, s)
                   : launch_path<false>(path, c, nullptr, st, q, nullptr, qo, nullptr, p, B, S,
                                        R, W, cluster, cols, tile, stages, threads, smem, s);
  return static_cast<int>(err);
}

// An empty kernel launched as `grid` CTAs of `threads` in clusters of
// `cluster`: what a launch costs on its own, the floor beside the bound.
extern "C" int quack_scan_floor_launch(int grid_x, int grid_y, int grid_z, int cluster,
                                       int threads, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, grid_y, grid_z);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
