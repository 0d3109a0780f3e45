// flash_attention_f32_sm90.cu: f32 online-softmax attention (causal and/or
// sliding window, grouped-query heads) on Hopper's tensor cores, in three TF32
// passes (3xTF32), fed by TMA. Written for NVIDIA Hopper (sm_90a); bf16 inputs
// go to flash_attention_sm90.cu.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_kernel) for f32 inputs. For q (B, H, Sq, D) and k, v
// (B, KV, Skv, D) it computes
//
//   o[b,h,i] = sum_j softmax_j(s[i,j]) v[b,kv(h),j],
//   s[i,j]   = (q[b,h,i] . k[b,kv(h),j]) / sqrt(D), or -1e30 where masked,
//
// with query i at position Skv - Sq + i, key j masked when causal and
// j > position or when window > 0 and j <= position - window, keys past Skv
// at -inf, kv(h) = h / (H/KV). The softmax and every sum are f32.
//
// Precision: the port holds f32 attention to the JAX tests' 2e-6, which one
// TF32 product (10 bits of mantissa) misses by two orders of magnitude. Each
// operand is split as x = hi + lo, hi = tf32(x), lo = tf32(x - hi), both
// rounded to nearest (cvt.rna), and a product is taken as
// hi.hi + (hi.lo + lo.hi): three tensor-core passes that keep about 21 bits
// of each term, the small passes issued first into the same f32
// accumulator. S = Q K^T and O += P V both take three passes; the row sum l
// comes from the f32 P. kernels.ref.mha_split_tf32 is the same split in
// plain torch. The tensor cores truncate (round toward zero) as they
// accumulate, so a sum that runs over a whole row drifts: P V accumulated in
// the wgmma registers across 1,024 keys read 1.7x the limit. Each tile's
// P V therefore starts from zero in registers of its own and is added to O
// in f32 (O = O exp(m_old - m_new) + PV, one rounding), which keeps every
// truncating sum 3 x 64 / 8 = 24 instructions long.
//
// What bounds it: operations. At granite-8b's widths in f32 (B = 1, H = 32,
// KV = 8, S = 2048, D = 128) the unmasked (q, k) pairs need 34.4 GFLOP at
// 4 D FLOPs a pair, three passes of it on the tensor cores: 209 us at the
// 495 TFLOP/s dense TF32 peak, 25 us at the memory rate. (On the FP32 FMA
// pipes, 67 TFLOP/s, the same work needs 513 us.)
//
// Design:
// * Pre-pass (split_kv_kernel, same call, same stream): per kv head, k is
//   split into k_hi and k_lo, and v into v^T_hi and v^T_lo (D x Skv rounded
//   up to 32), in a workspace the wrapper allocates. wgmma takes tf32
//   operands from shared memory K-major only (the transpose flag exists for
//   16-bit types), so P.V needs v^T: keys contiguous along each of the D
//   rows. The pre-pass also permutes the keys inside each group of 8 to
//   0, 2, 4, 6, 1, 3, 5, 7: a thread's S accumulator holds keys 2t and
//   2t + 1 of each group, where the tf32 A fragment of m64nNk8 wants keys
//   t and t + 4; with v^T permuted so, the accumulator pairs are the A
//   fragment as they stand, and the sum over keys is the same.
// * Main kernel: a block owns 64 query rows of one (b, h); warpgroup 0 is
//   the producer, warpgroup 1 the consumer. Grid (ceil(Sq / 64), B * H),
//   query blocks in reverse order so that the
//   longest causal rows start first. One producer thread issues every TMA
//   load: q once, then items k(t), v^T(t), k(t + 1), ... of kv tile t (hi
//   and lo together) into a ring of slots with full and empty mbarriers; a
//   consumer frees a k slot as soon as S is computed and a v slot once P.V
//   is, so the next tile's k loads during this tile's softmax and P.V.
// * q is loaded as f32 and split in place by the consumer: q_hi overwrites
//   q, q_lo goes to a second tile of the same layout (the 128-byte swizzle
//   moves an element to the same place in both), then fence.proxy.async
//   makes the writes visible to wgmma.
// * TMA loads through 3-D tensor maps, so the ragged end of each head is
//   zero-filled by the hardware, never read from the next head. q and k
//   rows are 128-byte swizzled (32 floats; a 512-byte row at D = 128 is four
//   boxes), 64-byte at D = 16; v^T rows are 32 keys, 128-byte swizzled.
//   The maps are encoded on the host for each call (cuTensorMapEncodeTiled
//   of libcuda, looked up through the CUDA runtime) and passed by value as
//   __grid_constant__ parameters.
// * S: wgmma m64n64k8, q and k from shared memory, 3 D / 8 instructions a
//   tile. Each score is scaled after the product by the f32 reciprocal of
//   sqrt(D) and masked in registers; the row max is shuffled among the 4
//   threads that share a row, and each keeps its share of the row sum l.
// * P V: P = exp(s - m) is split into P_hi and P_lo from the accumulator's
//   registers and fed as the register A operand, v^T_hi and v^T_lo from
//   shared memory, 3 x 64 / 8 instructions of m64nDk8 a tile into the tile's
//   own accumulator; then O = O exp(m_old - m_new) + PV by fmaf.
// * Masking is -1e30, as in the reference: a row whose keys are all masked
//   (causal with a position < 0) gets the uniform mean of v over all Skv
//   keys. A kv tile is skipped only when every row of the block has an
//   unmasked key and the tile holds none of them: masked keys of such rows
//   add exactly 0, so the result is bit-identical to visiting the tile.
//   Blocks holding an all-masked row visit every tile. Tiles with no masked
//   or missing key for the block's rows skip the mask tests.
// * exp(x - m) is exp2f((x - m) * log2(e)), the difference taken first, so
//   an all-masked row (x = m = -1e30) gets exactly 1. No fast-math.
// * Epilogue: O / max(l, 1e-30); only rows < Sq are stored.
// * Tiling: 64 query rows and 64-key tiles at every head dim. At D = 128 it
//   beat 32-key tiles with one or two consumer warpgroups (PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr int kKeyBox = 32;       // keys in a 128-byte row of a v^T box
constexpr int kMaxSlots = 4;
constexpr int kBQ = 64;           // query rows a block
constexpr int kBKV = 64;          // keys a kv tile
constexpr int kThreads = 256;     // the producer and the consumer warpgroup
constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout for head dim D: q_hi, q_lo, then kSlots slots, each
// the hi and lo tiles of k or of v^T, then the mbarriers. q and k tiles are
// [box][rows][box columns], v^T tiles [key box][D][32 keys], every box
// 1024-byte aligned.
template <int D>
struct Layout {
  static constexpr int kBoxCols = D < 32 ? D : 32;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 4;  // 64 or 128: the swizzle of q and k
  static constexpr int kQBytes = kBQ * D * 4;     // one of q_hi, q_lo
  static constexpr int kTileBytes = kBKV * D * 4;  // one of k_hi, k_lo, v^T_hi, v^T_lo
  static constexpr int kSlotBytes = 2 * kTileBytes;
  static constexpr int kFit = (kSmemMax - 1024 - 2 * kQBytes - 8 * (1 + 2 * kMaxSlots)) /
                              kSlotBytes;
  static constexpr int kSlots = kFit < kMaxSlots ? kFit : kMaxSlots;
  static constexpr int kBarOff = 2 * kQBytes + kSlots * kSlotBytes;
  static constexpr int kAlloc = kBarOff + (1 + 2 * kSlots) * 8 + 1024;  // slack to align
  // wgmma descriptor swizzle code of q and k: 1 = 128 B, 2 = 64 B
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;
  static_assert(kSlots >= 2, "a k and a v slot at least");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// tf32(x), rounded to nearest with ties away from zero; the low 13 bits are 0
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = __uint_as_float(tf32_rna(x));
  lo = __uint_as_float(tf32_rna(x - hi));
}

__device__ __forceinline__ void split_tf32(float4 x, float4& hi, float4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
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

// d (64 x 64, f32) (+)= A (64 x 8) . B (8 x 64); A and B tf32, K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 16, f32) (+)= A (64 x 8, tf32 fragment in registers) . B (8 x 16, tf32
// K-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 32, f32) (+)= A (64 x 8, tf32 fragment in registers) . B (8 x 32, tf32
// K-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) (+)= A (64 x 8, tf32 fragment in registers) . B (8 x 64, tf32
// K-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) (+)= A (64 x 8, tf32 fragment in registers) . B (8 x 128, tf32
// K-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, b, accumulate);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b, accumulate);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b, accumulate);
  else wgmma_rs_n128(d, a, b, accumulate);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- pre-pass
// One block a 32-key slab of one kv head: k_hi, k_lo in k's layout, and
// v^T_hi, v^T_lo (D x Skv_pad) with the keys of each group of 8 in the order
// 0, 2, 4, 6, 1, 3, 5, 7. Keys past Skv are 0 in v^T.
template <int D>
__global__ void __launch_bounds__(256)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ kh,
                float* __restrict__ kl, float* __restrict__ vth, float* __restrict__ vtl,
                int Skv, int Skv_pad) {
  __shared__ float tile[kKeyBox][D + 1];
  constexpr int kVec = D / 4;
  const int k0 = blockIdx.x * kKeyBox;
  const size_t head = blockIdx.y;
  for (int e = threadIdx.x; e < kKeyBox * kVec; e += blockDim.x) {
    const int row = e / kVec, col = (e % kVec) * 4;
    float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k0 + row < Skv) {
      const size_t at = (head * Skv + k0 + row) * D + col;
      float4 hi, lo;
      split_tf32(*reinterpret_cast<const float4*>(k + at), hi, lo);
      *reinterpret_cast<float4*>(kh + at) = hi;
      *reinterpret_cast<float4*>(kl + at) = lo;
      y = *reinterpret_cast<const float4*>(v + at);
    }
    tile[row][col] = y.x;
    tile[row][col + 1] = y.y;
    tile[row][col + 2] = y.z;
    tile[row][col + 3] = y.w;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < D * kKeyBox; e += blockDim.x) {
    const int d = e / kKeyBox, p = e % kKeyBox, r = p & 7;
    const int key = (p & ~7) | (r < 4 ? 2 * r : 2 * r - 7);
    float hi, lo;
    split_tf32(tile[key][d], hi, lo);
    const size_t at = (head * D + d) * Skv_pad + k0 + p;
    vth[at] = hi;
    vtl[at] = lo;
  }
}

// ------------------------------------------------------------- main kernel
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_f32_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tkh,
                           const __grid_constant__ CUtensorMap tkl,
                           const __grid_constant__ CUtensorMap tvh,
                           const __grid_constant__ CUtensorMap tvl, float* __restrict__ o, int H,
                           int KV, int Sq, int Skv, int causal, int window, float sqrt_d) {
  using L = Layout<D>;
  constexpr int kNS = kBKV / 2;  // S accumulators per consumer thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t qh_s = base, ql_s = base + L::kQBytes;
  const uint32_t bar_q = base + L::kBarOff;
  auto slot = [&](int s) { return base + 2 * L::kQBytes + s * L::kSlotBytes; };
  auto bar_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8 * (1 + L::kSlots + s); };

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
    for (int s = 0; s < L::kSlots; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int b = 0; b < L::kBoxes; ++b)
        tma_load(qh_s + b * kBQ * L::kRowBytes, &tq, b * L::kBoxCols, q0, bh, bar_q);
      // item 2 (t - t_lo) is k of tile t, the next one its v^T
      const int items = 2 * (t_hi - t_lo + 1);
      for (int i = 0; i < items; ++i) {
        const int s = i % L::kSlots, t = t_lo + i / 2;
        mbar_wait(bar_empty(s), ((i / L::kSlots) & 1) ^ 1);
        mbar_expect_tx(bar_full(s), L::kSlotBytes);
        if ((i & 1) == 0) {
          for (int b = 0; b < L::kBoxes; ++b) {
            const uint32_t dst = slot(s) + b * kBKV * L::kRowBytes;
            tma_load(dst, &tkh, b * L::kBoxCols, t * kBKV, kv_bh, bar_full(s));
            tma_load(dst + L::kTileBytes, &tkl, b * L::kBoxCols, t * kBKV, kv_bh, bar_full(s));
          }
        } else {
          for (int b = 0; b < kBKV / kKeyBox; ++b) {
            const uint32_t dst = slot(s) + b * D * kKeyBox * 4;
            tma_load(dst, &tvh, t * kBKV + b * kKeyBox, 0, kv_bh, bar_full(s));
            tma_load(dst + L::kTileBytes, &tvl, t * kBKV + b * kKeyBox, 0, kv_bh, bar_full(s));
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------------- consumer
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;                 // rows 16 warp .. of the block's 64
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, tq4 = lane % 4;    // thread's rows g, g + 8; columns 2 tq4 (+1)
    const int row0 = q0 + 16 * warp + g;       // query index of the first row
    const int qp0 = q_offset + row0, qp1 = qp0 + 8;  // positions of the two rows
    const int c_lo = q_offset + q0, c_hi = c_lo + kBQ - 1;  // the block's positions
    const float scale = 1.0f / sqrt_d;

    // split the q rows: q_hi in place, q_lo beside it
    mbar_wait(bar_q, 0);
    constexpr int kRowVecs = kBQ * L::kRowBytes / 16;  // float4s of a box
#pragma unroll
    for (int b = 0; b < L::kBoxes; ++b) {
      for (int i = tid; i < kRowVecs; i += 128) {
        const int at = b * kBQ * L::kRowBytes + 16 * i;
        float4* hi = reinterpret_cast<float4*>(smem + at);
        float4* lo = reinterpret_cast<float4*>(smem + L::kQBytes + at);
        split_tf32(*hi, *hi, *lo);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");

    // descriptors: q and k (K-major, swizzled like their boxes); v^T
    // (K-major, 128-byte rows of 32 keys)
    constexpr uint32_t kSBO = 8 * L::kRowBytes;  // 8 rows (or 8 keys)
    const uint64_t qh_desc = make_desc(qh_s, 16, kSBO, L::kSwizzle);
    const uint64_t ql_desc = make_desc(ql_s, 16, kSBO, L::kSwizzle);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m0 = kMask, m1 = kMask, l0 = 0.0f, l1 = 0.0f;  // l: this thread's share

    for (int t = t_lo, i = 0; t <= t_hi; ++t, i += 2) {
      const int sk = i % L::kSlots, sv = (i + 1) % L::kSlots;
      const int k0 = t * kBKV;

      // S = Q K^T: the small passes over D / 8 slices of 8 columns, then the big one
      mbar_wait(bar_full(sk), (i / L::kSlots) & 1);
      float sc[kNS];
      const uint64_t kh_desc = make_desc(slot(sk), 16, kSBO, L::kSwizzle);
      const uint64_t kl_desc = make_desc(slot(sk) + L::kTileBytes, 16, kSBO, L::kSwizzle);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int box = kk * 8 / L::kBoxCols, col = kk * 8 % L::kBoxCols;
        const uint32_t qo = (box * kBQ * L::kRowBytes + col * 4) >> 4;
        const uint32_t ko = (box * kBKV * L::kRowBytes + col * 4) >> 4;
        wgmma_ss_n64(sc, qh_desc + qo, kl_desc + ko, kk > 0);
        wgmma_ss_n64(sc, ql_desc + qo, kh_desc + ko, 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int box = kk * 8 / L::kBoxCols, col = kk * 8 % L::kBoxCols;
        const uint32_t qo = (box * kBQ * L::kRowBytes + col * 4) >> 4;
        const uint32_t ko = (box * kBKV * L::kRowBytes + col * 4) >> 4;
        wgmma_ss_n64(sc, qh_desc + qo, kh_desc + ko, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty(sk));

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

      // P in f32, its row sums, and P split into tf32 halves. The A fragment
      // of key slice j holds (row g, slot tq4), (g + 8, tq4), (g, tq4 + 4),
      // (g + 8, tq4 + 4); v^T's key order puts keys 2 tq4 and 2 tq4 + 1 in
      // those slots, so register r takes sc[4j + e] with r = 2 (e & 1) + (e >> 1).
      float sum0 = 0.0f, sum1 = 0.0f;
      uint32_t p_hi[kBKV / 8][4], p_lo[kBKV / 8][4];
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f((sc[4 * j + e] - (e < 2 ? n0 : n1)) * kLog2e);
          if (e < 2) sum0 += p; else sum1 += p;
          const int r = 2 * (e & 1) + (e >> 1);
          p_hi[j][r] = tf32_rna(p);
          p_lo[j][r] = tf32_rna(p - __uint_as_float(p_hi[j][r]));
        }
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;

      // pv = P V of this tile alone: the small passes over 64 / 8 slices of 8
      // keys, then the big one
      mbar_wait(bar_full(sv), ((i + 1) / L::kSlots) & 1);
      const uint64_t vh_desc = make_desc(slot(sv), 16, 8 * kKeyBox * 4, 1);
      const uint64_t vl_desc = make_desc(slot(sv) + L::kTileBytes, 16, 8 * kKeyBox * 4, 1);
      float pv[D / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j) {
        const uint32_t vo = ((j * 8 / kKeyBox) * D * kKeyBox * 4 + (j * 8 % kKeyBox) * 4) >> 4;
        wgmma_rs<D>(pv, p_lo[j], vh_desc + vo, j > 0);
        wgmma_rs<D>(pv, p_hi[j], vl_desc + vo, 1);
      }
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j) {
        const uint32_t vo = ((j * 8 / kKeyBox) * D * kKeyBox * 4 + (j * 8 % kKeyBox) * 4) >> 4;
        wgmma_rs<D>(pv, p_hi[j], vh_desc + vo, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pv);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty(sv));

      // O = O exp(m_old - m_new) + pv, rounded once
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] = fmaf(acc[4 * j], alpha0, pv[4 * j]);
        acc[4 * j + 1] = fmaf(acc[4 * j + 1], alpha0, pv[4 * j + 1]);
        acc[4 * j + 2] = fmaf(acc[4 * j + 2], alpha1, pv[4 * j + 2]);
        acc[4 * j + 3] = fmaf(acc[4 * j + 3], alpha1, pv[4 * j + 3]);
      }
    }

    // epilogue: the rows' sums over their 4 threads, O / l
    const float d0 = fmaxf(quad_sum(l0), 1e-30f), d1 = fmaxf(quad_sum(l1), 1e-30f);
    float* out = o + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * tq4;
      if (row0 < Sq)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row0) * D + col) =
            make_float2(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      if (row0 + 8 < Sq)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row0 + 8) * D + col) =
            make_float2(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
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

// An f32 (inner, rows, heads) map whose box is (box_inner, box_rows, 1),
// swizzled by the box's row of box_inner floats (64 or 128 bytes).
bool encode(CUtensorMap* map, const void* ptr, int inner, int rows, int heads, int box_inner,
            int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 4,
                                 static_cast<cuuint64_t>(rows) * inner * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_inner * 4 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int pad_keys(int Skv) { return (Skv + kKeyBox - 1) / kKeyBox * kKeyBox; }

template <int D>
cudaError_t launch_main(const void* q, const float* kh, const float* kl, const float* vth,
                        const float* vtl, void* o, int B, int H, int KV, int Sq, int Skv,
                        int causal, int window, float sqrt_d, cudaStream_t stream) {
  CUtensorMap tq, tkh, tkl, tvh, tvl;
  const int skv_pad = pad_keys(Skv);
  using L = Layout<D>;
  if (!encode(&tq, q, D, Sq, B * H, L::kBoxCols, kBQ) ||
      !encode(&tkh, kh, D, Skv, B * KV, L::kBoxCols, kBKV) ||
      !encode(&tkl, kl, D, Skv, B * KV, L::kBoxCols, kBKV) ||
      !encode(&tvh, vth, skv_pad, D, B * KV, kKeyBox, D) ||
      !encode(&tvl, vtl, skv_pad, D, B * KV, kKeyBox, D))
    return cudaErrorInvalidValue;
  auto kern = flash_attention_f32_kernel<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, L::kAlloc, stream>>>(tq, tkh, tkl, tvh, tvl, static_cast<float*>(o), H,
                                              KV, Sq, Skv, causal, window, sqrt_d);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int Sq, int Skv, int causal, int window, float sqrt_d, cudaStream_t stream,
                   float* ws) {
  const int skv_pad = pad_keys(Skv);
  const size_t nk = static_cast<size_t>(B) * KV * Skv * D;
  const size_t nv = static_cast<size_t>(B) * KV * D * skv_pad;
  float *kh = ws, *kl = kh + nk, *vth = kl + nk, *vtl = vth + nv;
  split_kv_kernel<D><<<dim3(skv_pad / kKeyBox, B * KV), 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), kh, kl, vth, vtl, Skv,
      skv_pad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_main<D>(q, kh, kl, vth, vtl, o, B, H, KV, Sq, Skv, causal, window, sqrt_d,
                        stream);
}

}  // namespace

// Floats of the workspace a call needs: k_hi, k_lo (B KV Skv D each), v^T_hi,
// v^T_lo (B KV D Skv_pad each, Skv_pad = Skv rounded up to 32).
extern "C" long long flash_attention_f32_sm90_workspace(int B, int KV, int Skv, int D) {
  return 2LL * B * KV * D * (static_cast<long long>(Skv) + pad_keys(Skv));
}

// Plain C entry point, loaded with ctypes. q, k, v and o are contiguous f32
// and 16-byte aligned; ws holds flash_attention_f32_sm90_workspace floats,
// 16-byte aligned; D is 16, 32, 64 or 128; H % KV == 0; window <= 0 means no
// window. Launches the pre-pass and the kernel on the stream; returns the
// CUDA error of the launches (0 on success; cudaErrorInvalidValue when a
// tensor map cannot be encoded).
extern "C" int flash_attention_f32_sm90_launch(const void* q, const void* k, const void* v,
                                               void* o, int B, int H, int KV, int Sq, int Skv,
                                               int D, int causal, int window, float sqrt_d,
                                               void* stream, void* ws) {
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<float*>(ws);
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, sqrt_d, s, w); break;
    case 32: err = launch<32>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, sqrt_d, s, w); break;
    case 64: err = launch<64>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, sqrt_d, s, w); break;
    case 128: err = launch<128>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, sqrt_d, s, w); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
