// flash_attention.cu: f32 online-softmax attention (causal and/or sliding
// window, grouped-query heads), written for NVIDIA Hopper (sm_90a). bf16
// inputs go to flash_attention_sm90.cu (wgmma and TMA) instead.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_kernel) for f32 inputs. For q (B, H, Sq, D) and k, v
// (B, KV, Skv, D), f32, it computes
//
//   o[b,h,i] = sum_j softmax_j(s[i,j]) v[b,h/(H/KV),j],
//   s[i,j]   = (q[b,h,i] . k[b,h/(H/KV),j]) / sqrt(D), or -1e30 where masked,
//
// with query i at position q_pos = Skv - Sq + i (aligned to the end, as in
// a prefill after a cache) and key j masked when causal and j > q_pos, or
// when window > 0 and j <= q_pos - window. Everything is f32.
//
// What bounds it: operations. At granite-8b's widths in f32 (B = 1,
// H = 32, KV = 8, S = 2048, D = 128) the unmasked (q, k) pairs need
// 34 GFLOP against 84 MB of q, k, v and o: 513 us on the f32 FMA pipes
// (67 TFLOP/s), 25 us at the memory rate. The products stay on those
// pipes: the port's f32 limit (2e-6, the JAX tests') rules out TF32 on the
// tensor cores.
//
// Design:
// * The TPU kernel walks the kv axis as a sequential grid dimension and
//   keeps (m, l, acc) in VMEM scratch. Here one block of 256 threads owns
//   a 64-row query tile of one (b, h) and loops over 64-key tiles itself;
//   m, l and the f32 accumulator stay in registers for the whole loop.
//   Grid: (ceil(Sq / 64), B * H), query tiles in reverse order so that the
//   longest causal rows start first.
// * q, k and v tiles are staged in shared memory: 98 KB at D = 128, so
//   the launch raises the dynamic shared-memory limit first; two blocks
//   fit on an SM. The P tile reuses k's space once S is computed.
// * Thread (tx, ty) of the 16 x 16 block computes S for rows ty + 16a and
//   keys tx + 16c (a, c < 4) from float4 reads of padded rows (conflict
//   free), reduces row max and sum with shuffles inside its half-warp, and
//   accumulates o for the same rows over D/16 columns.
// * Masking is -1e30, as in the reference: a row whose keys are all
//   masked (causal with q_pos < 0) gets the uniform mean of v over all
//   Skv keys. A kv tile is skipped only when every row of the block has an
//   unmasked key and the tile holds none of them: masked keys of such rows
//   add exactly 0 (exp(-1e30 - m) underflows to 0, and a later real max
//   rescales any earlier all-masked tile by exp(-1e30 - m) = 0), so the
//   result is bit-identical to visiting the tile. Blocks holding an
//   all-masked row visit every tile. Keys past Skv score -inf and add 0.
// * Each dot product is scaled after it is summed, by the f32 reciprocal
//   of sqrt(D), as the plain version on the card scales its scores; q is
//   not scaled before the product, which would round every term once more.
// * expf, not __expf; no fast-math; never TF32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 64;       // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kMask = -1e30f;

template <int D>
struct Layout {
  static constexpr int kLD = D + 4;      // row stride of the q and k tiles (floats)
  static constexpr int kLDP = kBKV + 16; // row stride of the P tile
  static constexpr int kQ = kBQ * kLD;
  static constexpr int kKP = kBKV * kLD > kBQ * kLDP ? kBKV * kLD : kBQ * kLDP;
  static constexpr int kV = kBKV * D;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKP + kV);
  // output columns of a thread: c * 16 * kVD + tx * kVD + e, c < kNC, e < kVD
  static constexpr int kVD = D >= 64 ? 4 : D / 16;
  static constexpr int kNC = D / (16 * kVD);
  static constexpr int kCols = kNC * kVD;
};

// Rows [row0, row0 + 64) of a (nrows, D) matrix into a tile with row
// stride LD; rows past nrows are zero.
template <int D, int LD>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int row0,
                                          int nrows, float* dst) {
  constexpr int kVec = D / 4;
  for (int e = threadIdx.x; e < kBQ * kVec; e += kThreads) {
    const int row = e / kVec, col = (e % kVec) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + row < nrows)
      x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + row) * D + col);
    *reinterpret_cast<float4*>(dst + row * LD + col) = x;
  }
}

// The kCols values of one v row that thread tx accumulates.
template <int D>
__device__ __forceinline__ void load_v(const float* row, int tx, float (&vv)[Layout<D>::kCols]) {
  using L = Layout<D>;
  if constexpr (L::kVD == 4) {
#pragma unroll
    for (int c = 0; c < L::kNC; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(row + c * 64 + tx * 4);
      vv[4 * c] = x.x;
      vv[4 * c + 1] = x.y;
      vv[4 * c + 2] = x.z;
      vv[4 * c + 3] = x.w;
    }
  } else if constexpr (L::kVD == 2) {
    const float2 x = *reinterpret_cast<const float2*>(row + tx * 2);
    vv[0] = x.x;
    vv[1] = x.y;
  } else {
    vv[0] = row[tx];
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int H, int KV,
                       int Sq, int Skv, int causal, int window, float sqrt_d) {
  using L = Layout<D>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + L::kQ;
  float* ps = ks;  // P overwrites k once S is computed
  float* vs = ks + L::kKP;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const int kv_bh = (bh / H) * KV + (bh % H) / (H / KV);
  const size_t q_base = static_cast<size_t>(bh) * Sq * D;
  const size_t kv_base = static_cast<size_t>(kv_bh) * Skv * D;
  const int q_offset = Skv - Sq;
  const float scale = 1.0f / sqrt_d;

  load_tile<D, L::kLD>(q + q_base, q0, Sq, qs);

  float m[4], l[4], acc[4][L::kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kMask;
    l[a] = 0.0f;
#pragma unroll
    for (int e = 0; e < L::kCols; ++e) acc[a][e] = 0.0f;
  }

  // kv tiles to visit; see the note on skipping at the top of the file
  const int qp_lo = q_offset + q0;
  const int qp_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  int t_lo = 0, t_hi = (Skv - 1) / kBKV;
  if (!(causal && qp_lo < 0)) {
    if (causal) t_hi = min(t_hi, qp_hi / kBKV);
    if (window > 0) t_lo = max(0, qp_lo - window + 1) / kBKV;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();  // the previous tile's P and v are consumed
    load_tile<D, L::kLD>(k + kv_base, k0, Skv, ks);
    load_tile<D, D>(v + kv_base, k0, Skv, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(qs + (ty + 16 * a) * L::kLD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kc[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * L::kLD + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = fmaf(qa[a].x, kc[c].x, s[a][c]);
          s[a][c] = fmaf(qa[a].y, kc[c].y, s[a][c]);
          s[a][c] = fmaf(qa[a].z, kc[c].z, s[a][c]);
          s[a][c] = fmaf(qa[a].w, kc[c].w, s[a][c]);
        }
    }
    __syncthreads();  // every thread is done with k before P overwrites it

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qp = q_offset + q0 + ty + 16 * a;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        float x = s[a][c] * scale;
        if (j >= Skv) {
          x = -INFINITY;  // no such key
        } else if ((causal && j > qp) || (window > 0 && j <= qp - window)) {
          x = kMask;
        }
        s[a][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[a], half_warp_max(mx));
      const float alpha = expf(m[a] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[a][c] - m_new);
        sum += p;
        ps[(ty + 16 * a) * L::kLDP + tx + 16 * c] = p;
      }
      l[a] = l[a] * alpha + half_warp_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < L::kCols; ++e) acc[a][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBKV; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(ps + (ty + 16 * a) * L::kLDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[L::kCols];
        load_v<D>(vs + (j + jj) * D, tx, vv);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float p = jj == 0 ? pa[a].x : jj == 1 ? pa[a].y : jj == 2 ? pa[a].z : pa[a].w;
#pragma unroll
          for (int e = 0; e < L::kCols; ++e) acc[a][e] = fmaf(p, vv[e], acc[a][e]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i < Sq) {
      const float denom = fmaxf(l[a], 1e-30f);
      float* row = o + q_base + static_cast<size_t>(i) * D;
#pragma unroll
      for (int c = 0; c < L::kNC; ++c)
#pragma unroll
        for (int e = 0; e < L::kVD; ++e)
          row[c * 16 * L::kVD + tx * L::kVD + e] = acc[a][c * L::kVD + e] / denom;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int KV, int Sq, int Skv, int causal, int window, float sqrt_d,
                   cudaStream_t stream) {
  using L = Layout<D>;
  auto kern = flash_attention_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KV, Sq, Skv, causal, window,
      sqrt_d);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. All tensors are contiguous f32
// and 16-byte aligned; H % KV == 0; window <= 0 means no window. Returns
// the CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int KV, int Sq, int Skv, int D,
                                      int causal, int window, float sqrt_d, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, sqrt_d, s); break;
    case 32: err = launch<32>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, sqrt_d, s); break;
    case 64: err = launch<64>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, sqrt_d, s); break;
    case 128: err = launch<128>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, sqrt_d, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
