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
// 3.35 TB/s; without it, 24.9 MB, about 7.4 us. Every protocol round
// launches it twice, once with and once without the loss quorum; the
// windowed engine once more per rotating chunk, for its GC frontier.
//
// Design:
// * No sequential grid. The TPU kernel carries the prefix across W-blocks
//   in a scratch cell, which relies on the TPU running its grid in order.
//   Here the grid is (ceil(W / columns per block), S, B) and blocks run in
//   any order: each block finds its first unquacked column (warp
//   __reduce_min_sync, then a shared-memory min over the warps) and issues
//   one atomicMin on prefix[b, s], which the wrapper fills with W
//   beforehand. A min does not depend on order, so the result is
//   deterministic and equals cumprod(quacked).sum().
// * Each block reads its own lane's stakes (staged in shared memory) and
//   thresholds (through device pointers, so a run never syncs the host
//   for them); R is a runtime value.
// * No padding: the ragged edge of W is masked here, not padded by the
//   caller.
// * Sum order: r ascending, in f32. claims are 0/1, so each term is the
//   stake or 0 exactly, and FMA contraction cannot change a sum. The plain
//   torch version sums in the same order, so the two agree bit for bit
//   even for non-integer stakes.
// * Loads: when W is a multiple of 16 and every pointer is 16-byte
//   aligned, each thread owns 16 neighbouring columns and reads them with
//   one 16-byte load per replica row; otherwise one column per thread.
// * The compute_lost = false variant never touches the complaints.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int VEC>
__device__ __forceinline__ void load_cols(const uint8_t* p, uint8_t (&b)[VEC]) {
  if constexpr (VEC == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      b[i] = static_cast<uint8_t>((words[i >> 2] >> (8 * (i & 3))) & 0xffu);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) b[i] = __ldg(p + i);
  }
}

template <int VEC>
__device__ __forceinline__ void store_cols(uint8_t* p, const uint8_t (&b)[VEC]) {
  if constexpr (VEC == 16) {
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      words[i >> 2] |= static_cast<uint32_t>(b[i]) << (8 * (i & 3));
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = b[i];
  }
}

// Stake-weighted sums of VEC columns of one (R, W) slab, r ascending.
template <int VEC>
__device__ __forceinline__ void weigh(const uint8_t* col, const float* stakes,
                                      int R, int W, float (&acc)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    uint8_t b[VEC];
    load_cols<VEC>(col + static_cast<size_t>(r) * W, b);
    const float st = stakes[r];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += b[i] ? st : 0.0f;
  }
}

template <int VEC, bool LOST>
__global__ void __launch_bounds__(kThreads)
quack_scan_kernel(const uint8_t* __restrict__ claims,
                  const uint8_t* __restrict__ complaints,
                  const float* __restrict__ stakes,
                  const float* __restrict__ qthr,
                  const float* __restrict__ dthr,
                  uint8_t* __restrict__ quacked, uint8_t* __restrict__ lost,
                  int* __restrict__ prefix, int R, int W) {
  extern __shared__ float s_stakes[];
  __shared__ int s_first[kWarps];
  const int b = blockIdx.z;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    s_stakes[r] = stakes[static_cast<size_t>(b) * R + r];
  }
  __syncthreads();

  const size_t bs = static_cast<size_t>(b) * gridDim.y + blockIdx.y;  // (b, s)
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  const size_t slab = bs * R * W;
  const size_t row = bs * W;
  int first = W;  // first unquacked column this thread owns; W = none
  // With VEC = 16 the wrapper guarantees W % 16 == 0, so a vector that
  // starts in range ends in range.
  if (col < W) {
    float acc[VEC];
    weigh<VEC>(claims + slab + col, s_stakes, R, W, acc);
    const float q = __ldg(qthr + b);
    uint8_t qk[VEC];
#pragma unroll
    for (int i = VEC - 1; i >= 0; --i) {
      qk[i] = acc[i] >= q;
      if (!qk[i]) first = static_cast<int>(col) + i;
    }
    store_cols<VEC>(quacked + row + col, qk);
    if constexpr (LOST) {
      weigh<VEC>(complaints + slab + col, s_stakes, R, W, acc);
      const float d = __ldg(dthr + b);
      uint8_t lk[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) lk[i] = (acc[i] >= d) && !qk[i];
      store_cols<VEC>(lost + row + col, lk);
    }
  }

  // Block-wide min of `first`; every thread reaches this point.
  const unsigned warp_first = __reduce_min_sync(0xffffffffu, static_cast<unsigned>(first));
  if ((threadIdx.x & 31) == 0) s_first[threadIdx.x >> 5] = static_cast<int>(warp_first);
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = s_first[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) m = min(m, s_first[i]);
    if (m < W) atomicMin(prefix + bs, m);
  }
}

template <int VEC>
void launch(const uint8_t* claims, const uint8_t* complaints,
            const float* stakes, const float* qthr, const float* dthr,
            uint8_t* quacked, uint8_t* lost, int* prefix, int B, int S,
            int R, int W, bool compute_lost, cudaStream_t stream) {
  const int per_block = kThreads * VEC;
  const dim3 grid((W + per_block - 1) / per_block, S, B);
  const size_t smem = static_cast<size_t>(R) * sizeof(float);
  if (compute_lost) {
    quack_scan_kernel<VEC, true><<<grid, kThreads, smem, stream>>>(
        claims, complaints, stakes, qthr, dthr, quacked, lost, prefix, R, W);
  } else {
    quack_scan_kernel<VEC, false><<<grid, kThreads, smem, stream>>>(
        claims, nullptr, stakes, qthr, nullptr, quacked, nullptr, prefix, R, W);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. prefix must hold W in every
// entry before the call. Returns cudaGetLastError() after the launch.
extern "C" int quack_scan_launch(const void* claims, const void* complaints,
                                 const void* stakes, const void* qthr,
                                 const void* dthr, void* quacked, void* lost,
                                 void* prefix, int B, int S, int R, int W,
                                 int compute_lost, int vec16, void* stream) {
  const auto* c = static_cast<const uint8_t*>(claims);
  const auto* x = static_cast<const uint8_t*>(complaints);
  const auto* st = static_cast<const float*>(stakes);
  const auto* q = static_cast<const float*>(qthr);
  const auto* d = static_cast<const float*>(dthr);
  auto* qo = static_cast<uint8_t*>(quacked);
  auto* lo = static_cast<uint8_t*>(lost);
  auto* p = static_cast<int*>(prefix);
  auto strm = static_cast<cudaStream_t>(stream);
  if (vec16) {
    launch<16>(c, x, st, q, d, qo, lo, p, B, S, R, W, compute_lost != 0, strm);
  } else {
    launch<1>(c, x, st, q, d, qo, lo, p, B, S, R, W, compute_lost != 0, strm);
  }
  return static_cast<int>(cudaGetLastError());
}
