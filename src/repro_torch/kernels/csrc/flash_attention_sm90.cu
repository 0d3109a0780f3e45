// flash_attention_sm90.cu: bf16 online-softmax attention (causal and/or
// sliding window, grouped-query heads) on Hopper's tensor cores, fed by TMA.
// Written for NVIDIA Hopper (sm_90a); the f32 path is flash_attention.cu.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_kernel) for bf16 inputs. For q (B, H, Sq, D) and k, v
// (B, KV, Skv, D) it computes
//
//   o[b,h,i] = sum_j softmax_j(s[i,j]) v[b,kv(h),j],
//   s[i,j]   = (q[b,h,i] . k[b,kv(h),j]) / sqrt(D), or -1e30 where masked,
//
// with query i at position Skv - Sq + i, key j masked when causal and
// j > position or when window > 0 and j <= position - window, keys past Skv
// at -inf, kv(h) = h / (H/KV). The softmax and every sum are f32; o is
// rounded to bf16 (nearest even).
//
// What bounds it: operations. At granite-8b's causal prefill (B = 1,
// H = 32, KV = 8, S = 4096, D = 128) the unmasked (q, k) pairs need
// 137 GFLOP (4 D a pair) against 84 MB of q, k, v and o: 139 us at the
// 989 TFLOP/s bf16 tensor-core peak, 25 us at the memory rate.
//
// Precision: the reference keeps P in f32, and P rounded to bf16 misses the
// port's bf16 limit (atol 1e-5, rtol 1.6e-2) by about 16x. So P is split
// into P_hi = bf16(P) and P_lo = bf16(P - P_hi), and O += P_hi V + P_lo V:
// two tensor-core products on the same V tile, 16 bits of P's mantissa,
// 6 D FLOPs a pair where the plain product needs 4 D. The row sum l is
// taken from the f32 P. kernels.ref.mha_split_p is the same arithmetic in
// plain torch.
//
// Design:
// * A block of 384 threads owns 128 query rows of one (b, h): warpgroup 0
//   is the producer, warpgroups 1 and 2 are consumers of 64 rows each.
//   Grid (ceil(Sq / 128), B * H), query blocks in reverse order so that
//   the longest causal rows start first.
// * The producer drops to 24 registers (setmaxnreg) and one of its threads
//   issues every load: q once, then k and v tiles of 128 keys into a ring
//   of stages with full and empty mbarriers. The consumers rise to 240.
// * TMA loads through 3-D tensor maps (D, S, B * heads), so the ragged end
//   of each head is zero-filled by the hardware, never read from the next
//   head. Rows are 128-byte swizzled at D = 64 and 128 (a 256-byte row at
//   D = 128 is two 64-column boxes), 64-byte at D = 32, 32-byte at D = 16;
//   the wgmma descriptors name the same mode. The maps are encoded on the
//   host for each call (cuTensorMapEncodeTiled of libcuda, looked up
//   through the CUDA runtime, so the library needs no -lcuda) and passed
//   by value as __grid_constant__ parameters.
// * S = Q K^T: wgmma m64n128k16, Q and K (K-major) from shared memory, f32
//   accumulators. Each score is scaled after the product by the f32
//   reciprocal of sqrt(D) and masked in registers; the row max is shuffled
//   among the 4 threads that share a row, and each of them keeps its share
//   of the row sum l, added up in the epilogue.
// * O += P V: the f32 accumulator fragment of S is, pair by pair, the
//   register A fragment of the next product, so P_hi and P_lo are built in
//   place and fed as A from registers; V is read as an MN-major B operand
//   (the transpose flag), so there is no transpose pass. O is rescaled by
//   exp(m_old - m_new) before the products, as in the reference.
// * Masking is -1e30, as in the reference: a row whose keys are all masked
//   (causal with a position < 0) gets the uniform mean of v over all Skv
//   keys. A kv tile is skipped only when every row of the 128-row block has
//   an unmasked key and the tile holds none of them: masked keys of such
//   rows add exactly 0, so the result is bit-identical to visiting the
//   tile. Blocks holding an all-masked row visit every tile. Tiles with no
//   masked or missing key for a consumer's rows skip the mask tests.
// * exp(x - m) is exp2f((x - m) * log2(e)): the difference is taken
//   first, so an all-masked row (x = m = -1e30) gets exactly 1, and the
//   share of the bf16 limit used reads the same as with expf. No
//   fast-math.
// * Epilogue: O / max(l, 1e-30), rounded to bf16; only rows < Sq are
//   stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;       // query rows per block
constexpr int kBKV = 128;      // keys per tile
constexpr int kThreads = 384;  // one producer and two consumer warpgroups
constexpr int kNS = kBKV / 2;  // S accumulators per consumer thread
constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout for head dim D: q, then kStages (k, v) pairs, each
// tile [box][rows][box columns] bf16 with 1024-byte aligned boxes, then the
// mbarriers.
template <int D>
struct Layout {
  static constexpr int kBoxCols = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;          // 32, 64 or 128: the swizzle
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBKV * D * 2;           // one k or v tile
  static constexpr int kStages = 2;  // a third stage measured no faster at D = 128
  static constexpr int kBarOff = kQBytes + kStages * 2 * kKVBytes;
  static constexpr int kBytes = kBarOff + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;            // slack to align the base
  // wgmma descriptor swizzle code: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A box of a 3-D tensor map into shared memory; completion is counted in
// bytes on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads of the accumulators above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) (+)= A (64 x 16) . B (16 x 128); A and B bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 16, f32) += A (64 x 16, bf16 fragment in registers) . B (16 x 16, bf16
// MN-major in shared memory, hence the transpose flag)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32, f32) += A (64 x 16, bf16 fragment in registers) . B (16 x 32, bf16
// MN-major in shared memory, hence the transpose flag)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 fragment in registers) . B (16 x 64, bf16
// MN-major in shared memory, hence the transpose flag)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 fragment in registers) . B (16 x 128, bf16
// MN-major in shared memory, hence the transpose flag)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 16) wgmma_rs_n16(d, a, b);
  else if constexpr (D == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                            int H, int KV, int Sq, int Skv, int causal, int window, float sqrt_d) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar_q = base + L::kBarOff;
  auto k_s = [&](int s) { return base + L::kQBytes + s * 2 * L::kKVBytes; };
  auto v_s = [&](int s) { return k_s(s) + L::kKVBytes; };
  auto bar_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8 * (1 + L::kStages + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const int kv_bh = (bh / H) * KV + (bh % H) / (H / KV);
  const int q_offset = Skv - Sq;

  // kv tiles to visit; see the note on skipping at the top of the file
  const int qp_lo = q_offset + q0;
  const int qp_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  int t_lo = 0, t_hi = (Skv - 1) / kBKV;
  if (!(causal && qp_lo < 0)) {
    if (causal) t_hi = min(t_hi, qp_hi / kBKV);
    if (window > 0) t_lo = max(0, qp_lo - window + 1) / kBKV;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int b = 0; b < L::kBoxes; ++b)
        tma_load(q_s + b * kBQ * L::kRowBytes, &tq, b * L::kBoxCols, q0, bh, bar_q);
      for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
        const int s = i % L::kStages;
        mbar_wait(bar_empty(s), ((i / L::kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full(s), 2 * L::kKVBytes);
        for (int b = 0; b < L::kBoxes; ++b) {
          const uint32_t off = b * kBKV * L::kRowBytes;
          tma_load(k_s(s) + off, &tk, b * L::kBoxCols, t * kBKV, kv_bh, bar_full(s));
          tma_load(v_s(s) + off, &tv, b * L::kBoxCols, t * kBKV, kv_bh, bar_full(s));
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;                      // rows 64c .. 64c + 63 of the block
    const int warp = (threadIdx.x / 32) % 4;   // rows 16 warp .. of the consumer's 64
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, tq4 = lane % 4;    // thread's rows g, g + 8; columns 2 tq4 (+1)
    const int row0 = q0 + 64 * c + 16 * warp + g;  // query index of the first row
    const int qp0 = q_offset + row0, qp1 = qp0 + 8;  // positions of the two rows
    const int c_lo = q_offset + q0 + 64 * c, c_hi = c_lo + 63;
    const float scale = 1.0f / sqrt_d;

    // descriptors: q rows of this consumer (K-major); k (K-major) and v
    // (MN-major) of stage 0, advanced by byte offsets below
    constexpr uint32_t kSBO = 8 * L::kRowBytes;          // 8 rows (or 8 keys)
    const uint64_t q_desc = make_desc(q_s + 64 * c * L::kRowBytes, 16, kSBO, L::kSwizzle);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m0 = kMask, m1 = kMask, l0 = 0.0f, l1 = 0.0f;  // l: this thread's share

    mbar_wait(bar_q, 0);
    for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
      const int s = i % L::kStages;
      const int k0 = t * kBKV;
      mbar_wait(bar_full(s), (i / L::kStages) & 1);

      // S = Q K^T over D / 16 slices of 16 columns
      float sc[kNS];
      const uint64_t k_desc = make_desc(k_s(s), 16, kSBO, L::kSwizzle);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk * 16 / L::kBoxCols, col = kk * 16 % L::kBoxCols;
        const uint64_t qa = q_desc + ((box * kBQ * L::kRowBytes + col * 2) >> 4);
        const uint64_t kb = k_desc + ((box * kBKV * L::kRowBytes + col * 2) >> 4);
        wgmma_ss_n128(sc, qa, kb, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale, mask, row max; sc[4j + e] is row g + 8 (e >> 1), key
      // k0 + 8j + 2 tq4 + (e & 1)
      const bool unmasked = k0 + kBKV <= Skv && !(causal && k0 + kBKV - 1 > c_lo) &&
                            !(window > 0 && k0 <= c_hi - window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNS / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale;
          if (!unmasked) {
            const int key = k0 + 8 * j + 2 * tq4 + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            if (key >= Skv) {
              x = -INFINITY;  // no such key
            } else if ((causal && key > qp) || (window > 0 && key <= qp - window)) {
              x = kMask;
            }
          }
          sc[4 * j + e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
      const float alpha0 = exp2f((m0 - n0) * kLog2e), alpha1 = exp2f((m1 - n1) * kLog2e);
      m0 = n0;
      m1 = n1;

      // P in f32, its row sums, and P split into bf16 halves: the pairs
      // (sc[8kk + 2r], sc[8kk + 2r + 1]) are register r of the A fragment of
      // key slice kk
      float sum0 = 0.0f, sum1 = 0.0f;
      uint32_t p_hi[kBKV / 16][4], p_lo[kBKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r;
          const float mrow = (r & 1) ? n1 : n0;
          const float pa = exp2f((sc[e] - mrow) * kLog2e);
          const float pb = exp2f((sc[e + 1] - mrow) * kLog2e);
          if (r & 1) sum1 += pa + pb; else sum0 += pa + pb;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(pa, pb);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][r] = bf16x2_bits(hi);
          p_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(pa - hf.x, pb - hf.y));
        }
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }

      // O += P_hi V + P_lo V over kBKV / 16 slices of 16 keys
      const uint64_t v_desc = make_desc(v_s(s), kBKV * L::kRowBytes, kSBO, L::kSwizzle);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        const uint64_t vb = v_desc + ((kk * 16 * L::kRowBytes) >> 4);
        wgmma_rs<D>(acc, p_hi[kk], vb);
        wgmma_rs<D>(acc, p_lo[kk], vb);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty(s));
    }

    // epilogue: the rows' sums over their 4 threads, O / l in bf16
    const float d0 = fmaxf(quad_sum(l0), 1e-30f), d1 = fmaxf(quad_sum(l1), 1e-30f);
    __nv_bfloat16* out = o + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * tq4;
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row0) * D + col) =
            __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      if (row0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row0 + 8) * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
  }
}

// ------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (D, rows, heads) bf16 map whose box is (box columns, box rows, 1).
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int rows, int heads, int box_rows) {
  using L = Layout<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::kBoxCols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = L::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : L::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int Sq, int Skv, int causal, int window, float sqrt_d, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv;
  if (!encode<D>(&tq, q, Sq, B * H, kBQ) || !encode<D>(&tk, k, Skv, B * KV, kBKV) ||
      !encode<D>(&tv, v, Skv, B * KV, kBKV))
    return cudaErrorInvalidValue;
  auto kern = flash_attention_sm90_kernel<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, L::kAlloc, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, KV,
                                              Sq, Skv, causal, window, sqrt_d);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. q, k, v and o are contiguous
// bf16 and 16-byte aligned; D is 16, 32, 64 or 128; H % KV == 0; window
// <= 0 means no window. Returns the CUDA error of the launch (0 on
// success; cudaErrorInvalidValue when a tensor map cannot be encoded).
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* o,
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
