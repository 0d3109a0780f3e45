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
// What bounds it: bytes in f32, operations with bf16 inputs. Each step of
// each (b, h) needs 5 f32 operations per state entry (r . S, a multiply
// and an add; S = w S + k v, two multiplies and an add) and 5 D for the
// u bonus, which factors as y_j += v_j c with c = sum_i r_i u_i k_i. At
// rwkv6-7b's widths (H = 64, D = 64) with B = 2 and T = 4096: 10.9 GFLOP,
// 163 us at the f32 peak of 67 TFLOP/s, against 671 MB of f32 r, k, v, w
// and y, 200 us at 3.35 TB/s (403 MB and 120 us with bf16 inputs). This
// first version does 7 operations per entry (it adds the bonus entry by
// entry) and is held back by its shared-memory reads instead: every
// thread reads one float4 per state entry it owns per step, and a warp's
// 128-bit shared load takes four cycles even when its lanes share
// addresses, about 1 ms of issue at these widths. A thread that owns
// several columns as well as several rows would reuse each read; that is
// the next step.
//
// Design:
// * The TPU kernel walks chunks as a sequential grid dimension so that S
//   stays in VMEM. Here S stays in registers for the whole sequence and
//   the loop over T runs inside the block; nothing carries between blocks.
// * The D columns of S are independent: column j needs only v_t[j] and
//   the whole r_t, k_t, w_t. A block owns 32 columns (D < 32: all of
//   them) and a thread owns one column and every fourth row of it
//   (D / 4 registers of S), so the grid is (B * H, D / 32): 256 blocks of
//   128 threads at the widths above, about two per SM. The four threads of
//   a column add their partial dot products with two shuffles.
// * 32 steps at a time (16 at D = 128) are staged in shared memory with
//   coalesced loads: r, k, w interleaved as one float4 per (step, row), so
//   a thread reads its row's three values with one broadcast load, and the
//   block's v columns. bf16 is read as bf16 and widened to f32. The y of
//   the staged steps goes out through shared memory, coalesced, in f32.
// * No atomics: each output is summed in a fixed order, so runs repeat
//   bit for bit.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using repro_torch::to_f32;

template <int D>
struct Cfg {
  static constexpr int kCols = D < 32 ? D : 32;   // columns of S per block
  static constexpr int kThreads = 4 * kCols;      // four threads per column
  static constexpr int kRows = D / 4;             // rows of S per thread
  static constexpr int kSteps = D > 64 ? 16 : 32; // steps staged at a time
};

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ w, const T* __restrict__ u, float* __restrict__ y,
             int H, int T_len) {
  using C = Cfg<D>;
  __shared__ float4 rkw[C::kSteps][D];  // (r, k, w, unused) per staged step and row
  __shared__ float vs[C::kSteps][C::kCols];
  __shared__ float ys[C::kSteps][C::kCols];

  const int tid = threadIdx.x, g = tid & 3, cl = tid >> 2;
  const int bh = blockIdx.x, h = bh % H, col0 = blockIdx.y * C::kCols;
  const size_t base = static_cast<size_t>(bh) * T_len * D;

  float S[C::kRows], uu[C::kRows];  // rows g, g + 4, g + 8, ... of column col0 + cl
#pragma unroll
  for (int ii = 0; ii < C::kRows; ++ii) {
    S[ii] = 0.0f;
    uu[ii] = to_f32(u[h * D + g + 4 * ii]);
  }

  for (int t0 = 0; t0 < T_len; t0 += C::kSteps) {
    const int n = min(C::kSteps, T_len - t0);
    __syncthreads();  // the previous steps' rows are consumed and y is out
    for (int e = tid; e < n * D; e += C::kThreads) {
      const int s = e / D, i = e % D;
      const size_t at = base + static_cast<size_t>(t0 + s) * D + i;
      rkw[s][i] = make_float4(to_f32(r[at]), to_f32(k[at]), to_f32(w[at]), 0.0f);
    }
    for (int e = tid; e < n * C::kCols; e += C::kThreads) {
      const int s = e / C::kCols, c = e % C::kCols;
      vs[s][c] = to_f32(v[base + static_cast<size_t>(t0 + s) * D + col0 + c]);
    }
    __syncthreads();

    for (int s = 0; s < n; ++s) {
      const float vj = vs[s][cl];
      float y0 = 0.0f, y1 = 0.0f;  // two chains halve the dependent adds
#pragma unroll
      for (int ii = 0; ii < C::kRows; ii += 2) {
        const float4 a = rkw[s][g + 4 * ii];
        const float kva = a.y * vj;
        y0 = fmaf(a.x, fmaf(uu[ii], kva, S[ii]), y0);
        S[ii] = fmaf(a.z, S[ii], kva);
        const float4 b = rkw[s][g + 4 * (ii + 1)];
        const float kvb = b.y * vj;
        y1 = fmaf(b.x, fmaf(uu[ii + 1], kvb, S[ii + 1]), y1);
        S[ii + 1] = fmaf(b.z, S[ii + 1], kvb);
      }
      float acc = y0 + y1;
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (g == 0) ys[s][cl] = acc;
    }
    __syncthreads();
    for (int e = tid; e < n * C::kCols; e += C::kThreads) {
      const int s = e / C::kCols, c = e % C::kCols;
      y[base + static_cast<size_t>(t0 + s) * D + col0 + c] = ys[s][c];
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* y, int BH, int H, int T_len, cudaStream_t stream) {
  using C = Cfg<D>;
  const dim3 grid(BH, D / C::kCols);
  rwkv6_kernel<T, D><<<grid, C::kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), static_cast<float*>(y), H, T_len);
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
// is (H, D), all of one type (bf16 when bf16 != 0, else f32) and
// contiguous; y is (BH, T, D) f32. Returns the CUDA error of the launch.
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v, const void* w,
                            const void* u, void* y, int BH, int H, int T_len, int D,
                            int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_d<__nv_bfloat16>(r, k, v, w, u, y, BH, H, T_len, D, s)
           : launch_d<float>(r, k, v, w, u, y, BH, H, T_len, D, s);
  return static_cast<int>(err);
}
