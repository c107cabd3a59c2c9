// int8 GEMM for the k = 1 layers (the 1x1x1 convs and the linears), for
// Hopper (sm_90a), with the activation quantized as it is loaded and a fused
// epilogue.
//
// Replaces: nestinet_tpu/ops/quant.py::conv_nd_int8 (:85-126) at a 1x1x1
// kernel and linear_int8 (:129-163), which JAX hands to XLA as an int8
// convolution / dot with preferred_element_type=int32, together with the
// quantize pass in front of them and, where BatchNorm is folded, the ReLU
// and the max|y| reduce after them.  The plain PyTorch version is
// nestinet_tpu_torch/ops/quant.py::int8_conv3d_fused_reference at k = 1,
// which this kernel equals bit for bit:
//
//   s_x         = max(amax, 1e-12) / 127                    (float32)
//   x_q[m, c]   = clip(rint(x[m, c] / s_x), -127, 127)       (int8)
//   acc[m, n]   = sum over c of x_q[m, c] * w_q[n, 0, c]     (int32)
//   y[m, n]     = bf16( float(acc) * (s_w[n] * s_x) + bias[n] )
//   out         = relu(y) if asked; out_amax = max |out| if asked
//
// with M = B * S rows (S = D * H * W cells a sample, 1 for a linear), N =
// cout and K = cin_p.  Layouts: x bf16 [B, C, S] (NCDHW, or a linear's
// [B, C]), w_q int8 [cout, 1, cin_p] (channels zero-padded, ops/quant.py),
// out bf16 [B, cout, S].
//
// What bounds it on an H100: bytes.  At the widest 1x1x1 conv (B = 256 on
// the 8^3 grid, 768 -> 256) the MACs take 26 us at the int8 peak and the
// activation's 201 MB alone 60 us at 3.35 TB/s; the linears (M <= 256) are
// bound by latency.  The design reads the activation once, in bf16, and
// spends no pass on it:
//   * 128 x BN output tiles, BN = the smallest of 32/64/128/256 that covers
//     cout, so that each activation is quantized once per tile (once
//     overall for cout <= 256); without a K split the grid is persistent, one
//     block an SM walking the tiles M first, so that the producer streams
//     the next tile while the consumers store the last;
//   * warpgroup 2 (one thread) streams each 64-channel K stage by TMA
//     through a ring up to 8 deep: the bf16 activation as two 64-row boxes
//     (a box over [B, C, S] of 64 cells x 64 channels, several samples where
//     S < 64, 128-byte swizzled at 64 cells; a linear's [B, C] as 64 rows x
//     64 channels, K-major) and w_q as 64 bytes of K x BN rows, 64-byte
//     swizzled.  TMA fills channels >= C, rows >= M and K >= cin_p with
//     zeros, so the channel tail (cin 20, 42, 60, 126; cin_p 16) costs no
//     code;
//   * consumer warpgroups 0 and 1 own 64 rows each.  int8 wgmma needs a
//     K-major A, and the activation is M-major (cells contiguous): each
//     thread takes its A fragment (rows g and g + 8, bytes 4q..4q+3 and
//     16 + 4q.. of each 32-byte K step) with ldmatrix.trans on the bf16 tile,
//     whose eight row addresses name the channels so that a thread receives
//     channel pairs it can pack (one byte_perm), quantizes in registers
//     (the branch-free fast rounding; one warp-uniform pass with the exact
//     division where a value lies near a tie), and issues wgmma m64nBNk32
//     with A from registers and B from shared memory;
//   * the epilogue in the plain version's order: s_w * s_x first (once a
//     column a tile, in shared memory), then a separate multiply and add
//     (__fmul_rn / __fadd_rn, which nvcc does not contract into an FMA),
//     round to nearest even to bf16, ReLU, max|out| (atomicMax on the float
//     bits, zeroed by the launcher); the bf16 tile is staged [col][row] by
//     stmatrix.trans and stored in runs of 8 rows of a column: one 16-byte
//     store along the cells, or for a linear 8 stores coalesced across the
//     warp;
//   * small M (the linears, the 2^3 grid at a routed sub-batch): a cluster of
//     2-8 blocks splits K; each block leaves its int32 tile in shared memory
//     and sums its share of the tile's runs over the cluster's tiles through
//     distributed shared memory, 16 bytes a load (integer sums: the result
//     is exact).
// The quantize is the conv kernels' (hopper.cuh).  |acc| <= 127^2 * K <
// 2^31 for K <= 133,000.  Every pointer into shared memory is an offset from
// the shared array itself: through an integer cast the compiler loses the
// address space and makes every access a generic 64-bit one.
//
// The PART_* macros are for scripts/int8_kernel_parts.py, which times builds
// with one part switched off; the library defines none.

#include <cstring>
#include <mutex>

#include "hopper.cuh"

namespace {

#ifndef PART_RING
#define PART_RING 8
#endif
constexpr int kBM = 128;             // rows of a block's tile: 64 per consumer warpgroup
constexpr int kBK = 64;              // channels (bf16) / bytes (int8) of K per stage
constexpr int kAHalf = 64 * kBK * 2; // bytes of one warpgroup's bf16 A box
constexpr int kMaxRing = PART_RING;  // depth of the ring, at most
constexpr int kMaxSplits = 8;        // blocks of a cluster that split K
constexpr int kThreads = 3 * kWG;

struct Gemm {
  int M;         // rows: B * S
  int S;         // cells a sample; 1 for a linear
  int cout;
  int k_stages;  // 64-channel stages of K: ceil(cin_p / 64)
  int sb;        // cells of a sample in an A box: min(S, 64); 0 for a linear (K-major A)
  int ring;      // depth of the ring
  int m_tiles, n_tiles;  // ceil(M / 128), ceil(cout / BN)
};

// Bytes of the bf16 staging tile of the epilogue without a K split,
// [BN][kBM + 8]: runs of 8 rows 16-byte aligned.
template <int BN>
struct Staging {
  static constexpr int kBytes = 2 * BN * (kBM + 8);
};

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Four 8 x 8 b16 matrices from mma fragments (thread t holds row t / 4,
// columns 2 (t % 4) and + 1 of each) into shared memory transposed: row j of
// matrix i, at the address lane 8 i + j gives, receives column j.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster: what was written before is visible after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of `p` in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// Eight consecutive int32 (16-byte aligned) of a block of the cluster.
__device__ __forceinline__ void ld_cluster_x8(int (&v)[8], uint32_t addr) {
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr));
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4 + 16];\n"
               : "=r"(v[4]), "=r"(v[5]), "=r"(v[6]), "=r"(v[7])
               : "r"(addr));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Two bf16 values (a 32-bit word, the lower first) -> their two int8 bytes
// in bytes 0 and 1.  `near` collects whether one lies within 2^-14 of a tie;
// kExact: such a value takes the exact quotient.  The fast pass has no
// branch, so that the scheduler can interleave a whole stage's values.
template <bool kExact>
__device__ __forceinline__ uint32_t quantize_pair(uint32_t w, float s_x, float inv_s,
                                                  bool& near) {
  const float lo = bf16_lo(w), hi = bf16_hi(w);
  bool n0, n1;
  uint32_t q0 = quantize_fast(lo, inv_s, n0), q1 = quantize_fast(hi, inv_s, n1);
  if (kExact) {
    if (n0) q0 = quantize_exact(lo, s_x);
    if (n1) q1 = quantize_exact(hi, s_x);
  }
  near = near || n0 || n1;
  return __byte_perm(q0, q1, 0x0040);  // the low bytes: q0, q1 (the upper two unused)
}

// Byte offset in a warpgroup's A box of bf16 row m (a cell) and channel c.
// A 64-cell box is one 128-byte line a channel, 128-byte swizzled (16-byte
// chunk m / 8 XOR c % 8); a box of 64 / sb samples of sb < 64 cells is
// [sample][channel][cell] without swizzle.
__device__ __forceinline__ int a_mmajor(int sb, int m, int c) {
  if (sb == 64) return c * 128 + ((((m >> 3) ^ (c & 7))) << 4) + (m & 7) * 2;
  const int smp = m / sb;
  return ((smp * 64 + c) * sb + (m - smp * sb)) * 2;
}

// A linear's A box: one 128-byte line a row of 64 channels, 128-byte swizzled.
__device__ __forceinline__ int a_kmajor(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// The four A registers of one 32-byte K step, in wgmma's order: rows g and
// g + 8 of the warp's 16 (g = lane / 4), bytes 4q..4q+3 then 16 + 4q..
// (q = lane % 4).  M-major: ldmatrix.trans of four 8 x 8 bf16 matrices,
// whose rows (one per lane, below) are channels, gives thread (g, q) cell g
// of channel pairs (4q, 4q+1) and (4q+2, 4q+3) (swapped for q >= 2: `sel`),
// then the same 16 channels up.  K-major: four 8-byte loads of 4 channels.
template <bool kExact>
__device__ __forceinline__ void a_fragment(const uint8_t* a, const int (&off)[4], bool kmajor,
                                           uint32_t sel, float s_x, float inv_s,
                                           uint32_t (&r)[4], bool& near) {
#ifdef PART_NO_QUANT
  (void)a; (void)off; (void)kmajor; (void)sel; (void)s_x; (void)inv_s; (void)near;
  r[0] = r[1] = r[2] = r[3] = 0x01010101u;
#else
  if (kmajor) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint2 v = *reinterpret_cast<const uint2*>(a + off[t]);
      r[t] = __byte_perm(quantize_pair<kExact>(v.x, s_x, inv_s, near),
                         quantize_pair<kExact>(v.y, s_x, inv_s, near), 0x5410);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t m[4];
      ldmatrix_x4_trans(m, smem_u32(a + off[h]));
      r[h] = __byte_perm(quantize_pair<kExact>(m[0], s_x, inv_s, near),
                         quantize_pair<kExact>(m[1], s_x, inv_s, near), sel);
      r[2 + h] = __byte_perm(quantize_pair<kExact>(m[2], s_x, inv_s, near),
                             quantize_pair<kExact>(m[3], s_x, inv_s, near), sel);
    }
  }
#endif
}

// wgmma m64nBNk32 s8 x s8 -> s32, A from registers, B from shared memory.
template <int BN>
struct WgmmaRS;

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<256> {
  static __device__ __forceinline__ void mma(int (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// The epilogue's arithmetic, in the plain version's order, on one int32 sum
// of output channel n: bf16, ReLU if asked.
__device__ __forceinline__ __nv_bfloat16 epilogue(int acc, int n, float s_x,
                                                  const float* __restrict__ s_w,
                                                  const float* __restrict__ bias, int relu) {
  const float scale = __fmul_rn(__ldg(s_w + n), s_x);
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), __ldg(bias + n));
  __nv_bfloat16 h = __float2bfloat16_rn(v);
  if (relu && __bfloat162float(h) < 0.0f) h = __float2bfloat16_rn(0.0f);
  return h;
}

__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The int8 GEMM.  Without a K split (one block a cluster) the grid is
// persistent: block b takes tiles b, b + gridDim.x, ... (M fastest, so that
// the blocks in flight share a weight tile in L2), and the producer streams
// the next tile's stages while the consumers store the last one.  With a K
// split each cluster takes one tile.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1) int8_gemm_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    const float* __restrict__ x_amax, const float* __restrict__ s_w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    float* __restrict__ out_amax, int relu, const Gemm g) {
  constexpr int kB = BN * kBK;           // bytes of a stage's B tile
  constexpr int kStage = 2 * kAHalf + kB;
  constexpr int kLdCol = kBM + 8;        // bf16 staging [BN][kLdCol], rows contiguous
  constexpr int kPCol = kBM + 4;         // int32 partial tile [BN][kPCol]
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned by an offset from the shared array itself, so that
  // the compiler keeps every pointer below in the shared space (32-bit
  // addresses, shared loads and stores) rather than generic
  uint8_t* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  __nv_bfloat16* staging = reinterpret_cast<__nv_bfloat16*>(ring + g.ring * kStage);
  float* col_scale = reinterpret_cast<float*>(ring + g.ring * kStage + Staging<BN>::kBytes);
  float* col_bias = col_scale + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(col_bias + BN);
  uint64_t* empty = full + kMaxRing;

  const int tid = threadIdx.x, wg = tid / kWG;
  const int rank = static_cast<int>(cluster_rank()), splits = static_cast<int>(cluster_blocks());
  const int ks0 = rank * g.k_stages / splits, ks1 = (rank + 1) * g.k_stages / splits;
  const int n_tiles = g.m_tiles * g.n_tiles;

  if (tid == 0) {
    for (int s = 0; s < g.ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWG / 32);  // a lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer: the activation's two boxes and B, by TMA
    setmaxnreg_dec<40>();
    if (tid == 2 * kWG) {
      int stage = 0;
      uint32_t phase = 0;
      uint32_t bytes = 0;
#ifndef PART_NO_A
      bytes += 2 * kAHalf;
#endif
#ifndef PART_NO_B
      bytes += kB;
#endif
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int m0 = (t % g.m_tiles) * kBM, n0 = (t / g.m_tiles) * BN;
        for (int ks = ks0; ks < ks1; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = ring + stage * kStage;
          if (bytes == 0) {
            mbar_arrive(&full[stage]);
          } else {
            mbar_arrive_expect_tx(&full[stage], bytes);
          }
#ifndef PART_NO_A
          for (int h = 0; h < 2; ++h) {
#ifdef PART_A_L2
            const int mh = 64 * h;  // every tile reads the first: the activation from L2
#else
            const int mh = m0 + 64 * h;  // M < 2^31 (the wrapper checks)
#endif
            if (g.sb == 0)
              tma_load_2d(st + h * kAHalf, &x_map, &full[stage], ks * kBK, mh);
            else
              tma_load_3d(st + h * kAHalf, &x_map, &full[stage], mh % g.S, ks * kBK, mh / g.S);
          }
#endif
#ifndef PART_NO_B
          tma_load_2d(st + 2 * kAHalf, &w_map, &full[stage], ks * kBK, n0);
#endif
          if (++stage == g.ring) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    __syncwarp();
    if (splits > 1) {
      cluster_sync();  // the partial tiles are written
      cluster_sync();  // the cluster has read them
    }
    return;
  }

  // ---------------- consumer warpgroups: 64 rows each
  setmaxnreg_inc<232>();
  const int warp = (tid % kWG) / 32, lane = tid % 32;
  const float s_x = __fdiv_rn(fmaxf(*x_amax, 1e-12f), 127.0f);
  const float inv_s = __frcp_rn(s_x);
  const bool kmajor = g.sb == 0;
  // this thread's byte offsets in its warpgroup's A box, per K step kk
  int off[2][4];
  uint32_t sel = 0x5410;
  if (kmajor) {
    const int gr = lane / 4, q = lane % 4;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t)  // t = h + 2 hi: row g + 8 h, bytes 16 hi + 4 q of the step
        off[kk][t] = a_kmajor(16 * warp + gr + 8 * (t & 1), 32 * kk + 16 * (t >> 1) + 4 * q);
  } else {
    // lane l names row j = l % 8 of matrix i = l / 8: the channel whose pair
    // thread q = j / 2 receives, 4q + j % 2 (+ 2 for i odd, swapped for q >= 2)
    // (+ 16 for i >= 2); rows 16 warp + 8 h .. + 7 of the box
    const int i = lane / 8, j = lane % 8, jq = j / 2;
    const int ch = 4 * jq + (j & 1) + 2 * ((i & 1) ^ (jq >> 1)) + 16 * (i >> 1);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      off[kk][0] = a_mmajor(g.sb, 16 * warp, 32 * kk + ch);
      off[kk][1] = a_mmajor(g.sb, 16 * warp + 8, 32 * kk + ch);
      off[kk][2] = off[kk][3] = 0;
    }
    if (lane % 4 >= 2) sel = 0x1054;
  }

  float local_max = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int m0 = (t % g.m_tiles) * kBM, n0 = (t / g.m_tiles) * BN;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int ks = ks0; ks < ks1; ++ks) {
      mbar_wait(&full[stage], phase);
      const uint8_t* st = ring + stage * kStage;
      uint32_t a0[4], a1[4];
      bool near = false;
      a_fragment<false>(st + wg * kAHalf, off[0], kmajor, sel, s_x, inv_s, a0, near);
      a_fragment<false>(st + wg * kAHalf, off[1], kmajor, sel, s_x, inv_s, a1, near);
      if (__any_sync(0xFFFFFFFFu, near)) {  // rare: the exact quotient decides near a tie
        a_fragment<true>(st + wg * kAHalf, off[0], kmajor, sel, s_x, inv_s, a0, near);
        a_fragment<true>(st + wg * kAHalf, off[1], kmajor, sel, s_x, inv_s, a1, near);
      }
#ifdef PART_NO_MMA
      acc[0] += static_cast<int>(a0[0] ^ a1[3]);
#else
      const uint64_t db = sw64_desc(st + 2 * kAHalf);
      wgmma_fence();
      WgmmaRS<BN>::mma(acc, a0, db);
      WgmmaRS<BN>::mma(acc, a1, db + 2);  // the second 32 bytes of K
      wgmma_commit();
      wgmma_wait<0>();
#endif
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == g.ring) {
        stage = 0;
        phase ^= 1;
      }
    }

    // accumulator i of a thread: row 16 warp + lane / 4 (+ 8 for i & 2) of
    // its warpgroup's 64, column 8 (i / 4) + 2 (lane % 4) + (i & 1).  Both
    // paths below keep the tile [col][row] in shared memory and store it in
    // runs of 8 rows of one column, enumerated in the order the output runs:
    // the cells first (one 16-byte store a run), or for a linear the columns
    // first (8 stores a run, each coalesced across the warp).
    const int row0 = wg * 64 + warp * 16 + lane / 4, col0 = 2 * (lane % 4);
    auto run_of = [&](int u, int& row, int& col) {
      if (kmajor) {
        col = u % BN;
        row = (u / BN) * 8;
      } else {
        col = u / (kBM / 8);
        row = (u % (kBM / 8)) * 8;
      }
    };
    auto store = [&](int m, int n, uint4 v) {  // rows m..m + 7 of channel n
      if (kmajor) {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (m + e < g.M)
            out[static_cast<long long>(m + e) * g.cout + n] =
                __ushort_as_bfloat16(static_cast<unsigned short>(w[e / 2] >> (16 * (e & 1))));
      } else {  // S % 8 == 0: the run lies in one sample, 16-byte aligned
        const int b = m / g.S;
        *reinterpret_cast<uint4*>(out + (static_cast<long long>(b) * g.cout + n) * g.S +
                                  (m - b * g.S)) = v;
      }
    };
    constexpr int kRuns = kBM * BN / 8;
    if (splits == 1) {
      // ---------------- the epilogue from registers, through bf16 staging
      named_barrier(1, 2 * kWG);  // the last tile's staging is stored
      if (tid < BN) {  // the tile's s_w * s_x and bias, once a column
        const int n = n0 + tid;
        col_scale[tid] = n < g.cout ? __fmul_rn(__ldg(s_w + n), s_x) : 0.0f;
        col_bias[tid] = n < g.cout ? __ldg(bias + n) : 0.0f;
      }
      named_barrier(1, 2 * kWG);
      // accumulators 4 c + 0..3 are rows (g, g, g + 8, g + 8) x columns (8 c
      // + 2 q, + 1, + 0, + 1): two 8 x 8 fragments a column block c, stored
      // transposed by stmatrix, four a call; lane l names column 8 (c + l /
      // 16) + l % 8, rows 8 ((l / 8) % 2) on from the warp's 16
      const uint32_t st_base = smem_u32(staging) +
          2u * static_cast<uint32_t>((((lane / 16) * 8 + lane % 8) * kLdCol) +
                                     wg * 64 + warp * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int c = 0; c < BN / 8; c += 2) {
        uint32_t pk[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {  // fragment f: column block c + f / 2, rows + 8 (f % 2)
          const int i = 4 * (c + f / 2) + 2 * (f % 2);
          const int row = row0 + 8 * (f % 2), col = 8 * (c + f / 2) + col0;
          const float2 sc = *reinterpret_cast<const float2*>(col_scale + col);
          const float2 bi = *reinterpret_cast<const float2*>(col_bias + col);
          __nv_bfloat16 lo = __float2bfloat16_rn(
              __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), sc.x), bi.x));
          __nv_bfloat16 hi = __float2bfloat16_rn(
              __fadd_rn(__fmul_rn(__int2float_rn(acc[i + 1]), sc.y), bi.y));
          if (relu && __bfloat162float(lo) < 0.0f) lo = __float2bfloat16_rn(0.0f);
          if (relu && __bfloat162float(hi) < 0.0f) hi = __float2bfloat16_rn(0.0f);
          if (m0 + row < g.M) {
            if (n0 + col < g.cout) local_max = fmaxf(local_max, fabsf(__bfloat162float(lo)));
            if (n0 + col + 1 < g.cout) local_max = fmaxf(local_max, fabsf(__bfloat162float(hi)));
          }
          pk[f] = bf16_pair(lo, hi);
        }
        stmatrix_x4_trans(st_base + 2u * static_cast<uint32_t>(c * 8 * kLdCol), pk[0], pk[1],
                          pk[2], pk[3]);
      }
      named_barrier(1, 2 * kWG);
#ifndef PART_NO_EPILOGUE
      for (int u = tid; u < kRuns; u += 2 * kWG) {
        int row, col;
        run_of(u, row, col);
        if (m0 + row < g.M && n0 + col < g.cout)
          store(m0 + row, n0 + col, *reinterpret_cast<const uint4*>(staging + col * kLdCol + row));
      }
#endif
    } else {
      // ---------------- split K: the int32 partial tiles over the ring (one
      // tile a cluster, so the ring is free), each block's share of the runs
      // summed over the cluster through distributed shared memory
      named_barrier(1, 2 * kWG);  // both warpgroups are done with the ring
      int* part = reinterpret_cast<int*>(ring);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int row = row0 + ((i & 2) ? 8 : 0), col = (i / 4) * 8 + col0 + (i & 1);
        part[col * kPCol + row] = acc[i];
      }
      cluster_sync();
      uint32_t peer[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) peer[r] = r < splits ? map_rank(part, r) : 0;
      for (int u = rank * kRuns / splits + tid; u < (rank + 1) * kRuns / splits; u += 2 * kWG) {
        int row, col;
        run_of(u, row, col);
        const int m = m0 + row, n = n0 + col;
        if (m >= g.M || n >= g.cout) continue;
        const int idx = col * kPCol + row;
        int sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#ifdef PART_NO_SUM
        for (int e = 0; e < 8; ++e) sum[e] = part[idx + e];
#else
#pragma unroll
        for (int r = 0; r < kMaxSplits; ++r) {
          if (r < splits) {
            int v[8];
            ld_cluster_x8(v, peer[r] + 4u * static_cast<uint32_t>(idx));
#pragma unroll
            for (int e = 0; e < 8; ++e) sum[e] += v[e];
          }
        }
#endif
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const __nv_bfloat16 lo = epilogue(sum[e], n, s_x, s_w, bias, relu);
          const __nv_bfloat16 hi = epilogue(sum[e + 1], n, s_x, s_w, bias, relu);
          if (m + e < g.M) local_max = fmaxf(local_max, fabsf(__bfloat162float(lo)));
          if (m + e + 1 < g.M) local_max = fmaxf(local_max, fabsf(__bfloat162float(hi)));
          w[e / 2] = bf16_pair(lo, hi);
        }
#ifndef PART_NO_EPILOGUE
        store(m, n, make_uint4(w[0], w[1], w[2], w[3]));
#endif
      }
      cluster_sync();  // the cluster is done reading this block's tile
    }
  }
  if (out_amax != nullptr) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      local_max = fmaxf(local_max, __shfl_xor_sync(0xFFFFFFFFu, local_max, s));
    // non-negative floats order as their bit patterns
    if (lane == 0) atomicMax(reinterpret_cast<int*>(out_amax), __float_as_int(local_max));
  }
}

// The TMA map of w_q [cout, cin_p] in boxes of 64 bytes of K x bn rows,
// 64-byte swizzled, cached by everything it encodes: the weights of a served
// model are fixed, so each layer's map is encoded once.
int weight_map(CUtensorMap* map, const void* w_q, int cin_p, int cout, int bn) {
  struct Entry {
    const void* ptr;
    int cin_p, cout, bn;
    CUtensorMap map;
  };
  static std::mutex lock;
  static Entry cache[256];
  static int n_cached = 0, next = 0;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n_cached; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == w_q && e.cin_p == cin_p && e.cout == cout && e.bn == bn) {
      std::memcpy(map, &e.map, sizeof(CUtensorMap));
      return 0;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cin_p), static_cast<cuuint64_t>(cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cin_p)};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(bn)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w_q),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kTensorMapError + static_cast<int>(res);
  Entry& e = cache[next];
  e = Entry{w_q, cin_p, cout, bn, *map};
  next = (next + 1) % 256;
  if (n_cached < 256) ++n_cached;
  return 0;
}

// The activation's TMA map, encoded per call: a linear's [B, C] in boxes of
// 64 channels x 64 rows (128-byte swizzle); else [B, C, S] in boxes of
// min(S, 64) cells x 64 channels x 64 / min(S, 64) samples (128-byte
// swizzle at 64 cells, none below).
int activation_map(CUtensorMap* map, const void* x, int B, int C, int S) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError;
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult res;
  if (S == 1) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C) * 2};
    const cuuint32_t box[2] = {kBK, 64};
    res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides,
                 box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const int sb = S < 64 ? S : 64;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(C),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(S) * 2,
                                   static_cast<cuuint64_t>(S) * C * 2};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(sb), kBK,
                               static_cast<cuuint32_t>(64 / sb)};
    res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides,
                 box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 sb == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return res == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(res);
}

template <int BN>
int launch(const CUtensorMap& xm, const CUtensorMap& wm, const void* x_amax, const void* s_w,
           const void* bias, void* out, void* out_amax, int relu, Gemm g, int splits,
           cudaStream_t stream) {
  constexpr int kStage = 2 * kAHalf + BN * kBK;
  constexpr int kFixed = 1024 + Staging<BN>::kBytes + 8 * BN + 2 * kMaxRing * 8;
  g.ring = (kSmemMax - kFixed) / kStage < kMaxRing ? (kSmemMax - kFixed) / kStage : kMaxRing;
  g.m_tiles = (g.M - 1) / kBM + 1;
  g.n_tiles = (g.cout + BN - 1) / BN;
  // a K split keeps its int32 partial tile [BN][kBM + 4] over the ring and the staging
  const int part = 4 * BN * (kBM + 4);
  if (g.ring < 2 || (splits > 1 && part > g.ring * kStage + Staging<BN>::kBytes))
    return kSmemError;
  const size_t smem = kFixed + static_cast<size_t>(g.ring) * kStage;
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_gemm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = g.m_tiles * g.n_tiles;
  cudaLaunchConfig_t cfg = {};
  // persistent without a K split; one tile a cluster with one
  cfg.gridDim = dim3(static_cast<unsigned>(splits == 1 && tiles > sms ? sms : tiles), 1,
                     static_cast<unsigned>(splits));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = static_cast<unsigned>(splits);
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_gemm_kernel<BN>, xm, wm, static_cast<const float*>(x_amax),
                           static_cast<const float*>(s_w), static_cast<const float*>(bias),
                           static_cast<__nv_bfloat16*>(out), static_cast<float*>(out_amax), relu,
                           g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the int8 GEMM on `stream`: x bf16 [B, C, S] (S = 1: a linear's
// [B, C]); w_q int8 [cout, 1, cin_p]; x_amax, the float32 bound the scale
// comes from; s_w, bias float32 [cout]; out bf16 [B, cout, S]; out_amax a
// float32 for max|out| (zeroed here, on the stream), or null; tiles of 128
// x bn (bn in {32, 64, 128, 256}), K split over clusters of `splits` blocks
// (1, 2, 4 or 8).  The activation's map needs 16-byte rows: S = 1 with C % 8
// == 0, S % 64 == 0, or S in {8, 16, 32}.  Returns 0 on success, a CUDA error code, 1000 + the
// CUresult of a failed tensor map, or 2000 where the tile would need more
// shared memory than a block has; allocates nothing and does not
// synchronise.  x and w_q 16-byte aligned.
int int8_gemm_launch(const void* x, const void* w_q, const void* x_amax, const void* s_w,
                     const void* bias, void* out, void* out_amax, int relu, int B, int C, int S,
                     int cin_p, int cout, int bn, int splits, void* stream) {
  const bool cin_ok = cin_p == 16 || cin_p == 32 || cin_p == 64 ||
                      (cin_p > 0 && cin_p % 128 == 0);
  const bool s_ok = S == 1 ? C % 8 == 0 : (S % 64 == 0 || S == 8 || S == 16 || S == 32);
  if (B < 0 || C <= 0 || C > cin_p || !cin_ok || !s_ok || cout <= 0 ||
      !(splits == 1 || splits == 2 || splits == 4 || splits == kMaxSplits))
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (static_cast<long long>(B) * S >= (1LL << 31)) return cudaErrorInvalidValue;
  Gemm g;
  g.M = B * S;
  g.S = S;
  g.cout = cout;
  g.k_stages = (cin_p + kBK - 1) / kBK;
  g.sb = S == 1 ? 0 : (S < 64 ? S : 64);

  CUtensorMap xm, wm;
  int res = activation_map(&xm, x, B, C, S);
  if (res != 0) return res;
  res = weight_map(&wm, w_q, cin_p, cout, bn);
  if (res != 0) return res;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_amax != nullptr) {
    const cudaError_t err = cudaMemsetAsync(out_amax, 0, sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (bn == 256) return launch<256>(xm, wm, x_amax, s_w, bias, out, out_amax, relu, g, splits, s);
  if (bn == 128) return launch<128>(xm, wm, x_amax, s_w, bias, out, out_amax, relu, g, splits, s);
  if (bn == 64) return launch<64>(xm, wm, x_amax, s_w, bias, out, out_amax, relu, g, splits, s);
  if (bn == 32) return launch<32>(xm, wm, x_amax, s_w, bias, out, out_amax, relu, g, splits, s);
  return cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  if (code == kSmemError) return "the tile needs more shared memory than a block has";
  if (code >= kTensorMapError) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
