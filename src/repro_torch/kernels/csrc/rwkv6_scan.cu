// rwkv6_scan.cu: the RWKV6 (Finch) recurrence with data-dependent decay,
// written for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_chunked
// (_kernel). For r, k, v, w (B, H, T, D) f32 or bf16 and u (H, D) it runs,
// per (b, h), from a zero (D, D) f32 state S,
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)     (a row of D)
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// and writes y (B, H, T, D) in f32; the final state is not returned.
//
// What bounds it: the f32 pipes and the memory, nearly evenly. Each state
// entry needs 3 f32 instructions a step (k_i v_j; S = w_i S + k_i v_j; the
// r_i S product of y, all three multiplies or FMAs). At rwkv6-7b's widths
// (H = 64, D = 64) with B = 2 and T = 4096 that is 2.15e9 entry-steps, about
// 0.19 ms on 132 SMs x 128 lanes at 1.98 GHz, against 671 MB of f32 r, k, v,
// w and y, 0.20 ms at 3.35 TB/s. A thread issues about 150 instructions a
// step for its 32 entries (96 at the floor), 14 of them loads, shuffles and
// a store, and with one block a SM (128 heads) a scheduler has one warp
// to issue from, so latency shows as well.
//
// Design:
// * One block owns one (b, h) for the whole sequence, so r, k, v, w are
//   read from memory once, and S never leaves registers: the TPU kernel's
//   sequential grid axis becomes the loop over T inside the block.
// * Register-blocked state: a thread owns a 4 x 8 tile of S (4 rows, 8
//   columns), so each step it reads 4 values of r, k and w and 8 of v,
//   five 128-bit shared loads in f32, for 96 f32 instructions. D / 4
//   threads share a column group; D = 64 runs 128 threads, D = 128 512.
// * The u bonus factors out of the D^2 work: y_j = sum_i r_i S_ij + v_j q
//   with q = sum_i r_i u_i k_i. Each thread adds its rows' share of q,
//   times v_j, to its partial sums, so q is summed by the same reduction.
// * The partial y of the threads that share a column group are summed by
//   a butterfly reduce-scatter over shuffles: each step halves the values
//   a lane holds (8, 4, 2, 1), then the last value is added across the
//   remaining lanes. A lane loads its 8 values of v as two float4s, the
//   half it keeps in the first step first, so that step needs no select;
//   the next two select the pair and the value to keep. Shared loads and
//   shuffles share the SM's memory-instruction pipe, so their count
//   matters beside the f32 work: v in two loads and two selected steps
//   runs faster than v in eight scalar loads. The lanes that end up with a
//   column write it straight to global memory: a warp writes 64
//   contiguous bytes a step (D = 64), the one instruction a shared-memory
//   staging store would cost too.
// * Staging: r, k, w, v are four separate (steps x D) arrays a stage, in
//   the input type (bf16 widened to f32 after the shared load). Each
//   head's slab of a stage is contiguous in memory, so one thread fills a
//   stage with four cp.async.bulk copies completed on an mbarrier. Three
//   stages keep the next two in flight while one is computed; the stage
//   just consumed is refilled after the block's one barrier a stage. The
//   stage depth follows the grid: as deep as lets every block the grid
//   puts on a SM hold its three stages, up to 64 KB a stage (16 steps of
//   f32 at D = 64 with four blocks a SM, 64 with one), since each stage
//   boundary costs the block a barrier and a pipeline refill. The last
//   stage may be short: T is a multiple of the caller's chunk only.
// * Order: every sum runs in a fixed order and there are no atomics, so
//   runs repeat bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::bulk_load;
using repro_torch::load4;
using repro_torch::mbar_expect_tx;
using repro_torch::mbar_fence_init;
using repro_torch::mbar_init;
using repro_torch::mbar_wait;
using repro_torch::smem_u32;

constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

constexpr int kStages = 3;
constexpr int kMaxStageBytes = 64 * 1024;

template <int D>
struct Cfg {
  static constexpr int kGroups = D / 4;           // threads sharing a column group
  static constexpr int kThreads = kGroups * D / 8;
  // reduce-scatter: halving steps, then values a lane keeps
  static constexpr int kHalve = log2i(kGroups) < 3 ? log2i(kGroups) : 3;
  static constexpr int kKeep = 8 >> kHalve;
  static constexpr unsigned kMask = kThreads >= 32 ? 0xffffffffu : (1u << kThreads) - 1;
  static constexpr int kMinBlocks = D == 64 ? 4 : 1;  // 128 registers at D = 64
  static_assert(kGroups <= 32 && 32 % kGroups == 0, "a column group within a warp");
};

// Sum p over the kGroups lanes g of a column group. p holds the lane's 8
// columns with the four that bit 0 of g keeps first. Step s pairs the
// lanes that differ in bit s of g: each keeps half of its values, the half
// that bit picks, and adds its partner's values of the same columns.
// Afterwards p[0, kKeep) hold the full sums of columns x, x + 1, ... of
// the group, x = 4 b0 + 2 b1 + b2 (b_s bit s of g, the bits kHalve
// covers).
template <typename C>
__device__ __forceinline__ void reduce_scatter(float (&p)[8], int g) {
#pragma unroll
  for (int m = 0; m < 4; ++m) p[m] += __shfl_xor_sync(C::kMask, p[m + 4], 1);
  const bool b1 = (g >> 1) & 1;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float send = b1 ? p[m] : p[m + 2];
    const float keep = b1 ? p[m + 2] : p[m];
    p[m] = keep + __shfl_xor_sync(C::kMask, send, 2);
  }
  if (C::kHalve == 3) {
    const bool b2 = (g >> 2) & 1;
    const float send = b2 ? p[0] : p[1];
    const float keep = b2 ? p[1] : p[0];
    p[0] = keep + __shfl_xor_sync(C::kMask, send, 4);
  }
#pragma unroll
  for (int bit = 1 << C::kHalve; bit < C::kGroups; bit <<= 1)
    p[0] += __shfl_xor_sync(C::kMask, p[0], bit);
}

// steps: the steps a stage holds, a multiple of 8. The dynamic shared
// memory holds kStages stages of 4 x steps x D values, then the mbarriers.
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kMinBlocks)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ w, const T* __restrict__ u, float* __restrict__ y,
             int H, int T_len, int steps) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int array = steps * D;                        // values of one staged array
  const uint32_t array_bytes = array * sizeof(T);
  const uint32_t smem0 = smem_u32(smem);
  const uint32_t bars = smem0 + kStages * 4 * array_bytes;

  const int tid = threadIdx.x, g = tid % C::kGroups, cg = tid / C::kGroups;
  const int bh = blockIdx.x, h = bh % H;
  const size_t base = static_cast<size_t>(bh) * T_len * D;
  const int n_chunks = (T_len + steps - 1) / steps;

  // one thread fills stage c % kStages with steps [c * steps, ...)
  auto issue = [&](int c) {
    const int s = c % kStages;
    const uint32_t bytes = min(steps, T_len - c * steps) * D * sizeof(T);
    const uint32_t bar = bars + 8 * s, dst = smem0 + s * 4 * array_bytes;
    const size_t at = base + static_cast<size_t>(c) * steps * D;
    mbar_expect_tx(bar, 4 * bytes);
    bulk_load(dst, r + at, bytes, bar);
    bulk_load(dst + array_bytes, k + at, bytes, bar);
    bulk_load(dst + 2 * array_bytes, w + at, bytes, bar);
    bulk_load(dst + 3 * array_bytes, v + at, bytes, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    mbar_fence_init();
    for (int c = 0; c < min(kStages, n_chunks); ++c) issue(c);
  }
  __syncthreads();

  // rows 4g .. 4g + 3 and columns cg * 8 + [0, 8), the four at `first`
  // held first; after the reduction the lane holds column cg * 8 + x
  const int first = 4 * (g & 1);
  int x = 0;
#pragma unroll
  for (int s = 0; s < C::kHalve; ++s) x |= ((g >> s) & 1) << (2 - s);
  const float4 u4 = load4(u + h * D + 4 * g);
  const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
  float S[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) S[i][j] = 0.0f;
  const bool writer = (g >> C::kHalve) == 0;
  float* yp = y + base + cg * 8 + x;

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages;
    const int n = min(steps, T_len - c * steps);
    mbar_wait(bars + 8 * s, (c / kStages) & 1);
    const T* rs = reinterpret_cast<const T*>(smem + s * 4 * array_bytes);
    const T* ks = rs + array;
    const T* ws = ks + array;
    const T* vs = ws + array + cg * 8;

#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float4 r4 = load4(rs + i * D + 4 * g);
      const float4 k4 = load4(ks + i * D + 4 * g);
      const float4 w4 = load4(ws + i * D + 4 * g);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
      const float4 va = load4(vs + i * D + first), vb = load4(vs + i * D + (first ^ 4));
      const float vv[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};

      // this thread's rows' share of q = sum_i r_i u_i k_i
      float q = rr[0] * (uu[0] * kk[0]);
#pragma unroll
      for (int ii = 1; ii < 4; ++ii) q = fmaf(rr[ii], uu[ii] * kk[ii], q);
      float p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = vv[j] * q;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = 0; j < 8; ++j) p[j] = fmaf(rr[ii], S[ii][j], p[j]);  // S_{t-1}
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = 0; j < 8; ++j) S[ii][j] = fmaf(ww[ii], S[ii][j], kk[ii] * vv[j]);

      reduce_scatter<C>(p, g);
      if (writer) {
        yp[0] = p[0];
        if (C::kKeep == 2) yp[1] = p[1];  // D = 16: columns x and x + 1
      }
      yp += D;
    }
    __syncthreads();  // stage s is consumed: refill it
    if (tid == 0 && c + kStages < n_chunks) issue(c + kStages);
  }
}

// The stage depth for a grid of BH blocks: as deep as lets the blocks the
// grid puts on each SM (at most what registers allow) hold kStages stages,
// in multiples of 8 steps, at most kMaxStageBytes a stage.
template <typename T, int D>
cudaError_t stage_steps(int BH, int dev, int* steps) {
  int sms = 0, sm_bytes = 0, reserved = 0, resident = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, rwkv6_kernel<T, D>,
                                                        Cfg<D>::kThreads, 0);
  if (err != cudaSuccess) return err;
  const int per_sm = max(1, min(resident, (BH + sms - 1) / sms));
  const int budget = min(sm_bytes / per_sm - reserved - 8 * kStages, kStages * kMaxStageBytes);
  *steps = budget / (kStages * 4 * D * static_cast<int>(sizeof(T))) / 8 * 8;
  return *steps >= 8 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* y, int BH, int H, int T_len, cudaStream_t stream) {
  auto kern = rwkv6_kernel<T, D>;
  int dev = 0, steps = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = stage_steps<T, D>(BH, dev, &steps);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int smem = kStages * 4 * steps * D * static_cast<int>(sizeof(T)) + 8 * kStages;
  kern<<<BH, Cfg<D>::kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), static_cast<float*>(y), H, T_len,
      steps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* r, const void* k, const void* v, const void* w,
                     const void* u, void* y, int BH, int H, int T_len, int D,
                     cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(r, k, v, w, u, y, BH, H, T_len, s);
    case 32: return launch<T, 32>(r, k, v, w, u, y, BH, H, T_len, s);
    case 64: return launch<T, 64>(r, k, v, w, u, y, BH, H, T_len, s);
    case 128: return launch<T, 128>(r, k, v, w, u, y, BH, H, T_len, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. r, k, v, w are (BH, T, D) and u
// is (H, D), all of one type (bf16 when bf16 != 0, else f32), contiguous and
// 16-byte aligned; y is (BH, T, D) f32. Returns the CUDA error of the launch.
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v, const void* w,
                            const void* u, void* y, int BH, int H, int T_len, int D,
                            int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_d<__nv_bfloat16>(r, k, v, w, u, y, BH, H, T_len, D, s)
           : launch_d<float>(r, k, v, w, u, y, BH, H, T_len, D, s);
  return static_cast<int>(err);
}
