// int8 implicit-GEMM SAME conv3d, stride 1, k > 1, for Hopper (sm_90a), with
// the activation quantized as it is loaded and a fused epilogue.  The 1x1x1
// convs and the linears (k = 1, a plain GEMM) run int8_gemm.cu instead.
//
// Replaces: nestinet_tpu/ops/quant.py::conv_nd_int8 (:85-126) and
// linear_int8 (:129-163), which JAX hands to XLA as an int8 convolution /
// dot with preferred_element_type=int32, together with the quantize pass
// in front of them and, where BatchNorm is folded, the ReLU and the max|y|
// reduce after them (JAX fuses that reduce into the producer's epilogue,
// ops/nn.py ActQ).  PyTorch has no int8 conv3d on CUDA.  The plain
// PyTorch version is nestinet_tpu_torch/ops/quant.py::
// int8_conv3d_fused_reference.
//
//   s_x           = max(amax, 1e-12) / 127                    (float32)
//   x_q[b, c, v]  = clip(rint(x[b, c, v] / s_x), -127, 127)    (int8)
//   acc[b, co, p] = sum over taps t and channels ci of
//                   x_q[b, ci, p + offset(t)] * w_q[co, t, ci]  (int32)
//   y[b, co, p]   = bf16( float(acc) * (s_w[co] * s_x) + bias[co] )
//   out           = relu(y) if asked; out_amax = max |out| if asked
//
// as a GEMM with M = B*D*H*W output positions, N = cout and K = k^3 * cin_p
// (cells outside the volume read 0, which is what zero-padding the float
// input gives, since quantization maps 0 to 0).
//
// Layouts: x bf16 NCDHW [B, C, D, H, W], the blocks' own layout; w_q int8
// [cout, k^3, cin_p] with the channels zero-padded to cin_p in {16, 32,
// 64} or a multiple of 128 (ops/quant.py), so one K index (tap, ci) runs
// along contiguous bytes and every 64- or 128-byte K tile holds whole taps
// or one slice of a tap; out bf16 NCDHW.  The padding is TensorFlow's SAME
// for stride 1: `pad` cells before, k - 1 - pad after.
//
// What bounds it on an H100: at the flagship's widest convs (M = 131072 at
// B = 256 on the 8^3 grid, K up to 125 * 256) the int8 MACs, about 10^12
// operations per conv against tens of MB moved: tensor-core work, which
// only wgmma reaches at full rate.  Two kernels share the arithmetic; the
// wrapper names one from the shape (ops/kernels/int8_cuda.py::kernel_for):
//   * int8_conv3d_direct_kernel, for the 8 x 8 grids (the 3^3 and 5^3
//     convs that hold most of the MACs).  There a core matrix of wgmma's A operand (8
//     rows x 16 bytes) is 8 consecutive cells of the quantized halo, so
//     wgmma reads A straight from it (no swizzle; 16-channel groups `lbo`
//     bytes apart, rows of cells `sbo` apart; the 8 x 8 grids zero-padded
//     so that every tap is a plain shift).  Producer warps 1-3 quantize the
//     halo of the next 32/64-channel slice into the other of two buffers
//     while the consumers multiply; producer warp 0 streams B by TMA in
//     64-byte K tiles through a ring up to 16 deep; the consumers step the
//     tap window without divisions and keep two wgmma groups in flight.
//   * int8_conv3d_kernel, the gather kernel, for the rest (k = 2, 4 on the
//     4^3 and 2^3 grids, and the k = 1 shapes whose activation no tensor
//     map takes, as a 3^3 grid's): the producer warpgroup quantizes the tile's halo
//     (the linear range of input cells its windows reach) per 128-channel
//     slice into shared memory, then gathers each 128-byte K tile's rows
//     from it with 16-byte copies into the 128-byte-swizzled layout, B by
//     TMA, a ring 4 deep.
// Both: one block per BM x BN output tile (BM 128 or 64, BN 128, 64 or 32,
// chosen by the wrapper from the shape so that small M fills the card too;
// consumer warpgroups 0..BM/64-1 own 64 rows each, the last warpgroup
// produces); mbarrier rings with one arrival per warp; the activation read
// bf16 NCDHW along the cells (16-byte vectors of 8 cells), the channel
// tail (cin 20, 42, 60, 126) zero per channel, each activation quantized
// once per block, not once per tap (125 times at k = 5);
//   * the division: x * (1 / s_x) rounded half to even without a branch,
//     and only where that lands within 2^-14 of a tie between two integers
//     (where it could round otherwise than the exact quotient) the value is
//     reloaded and __fdiv_rn decides; |x * r - x / s_x| <= 2^-16 for
//     |x / s_x| <= 128, so the result is the plain version's rint(x / s_x)
//     everywhere;
//   * wgmma.mma_async m64nBNk32 s8 x s8 -> s32 from shared memory;
//   * the epilogue in the plain version's order: s_w * s_x first, then a
//     separate multiply and add (__fmul_rn / __fadd_rn, which nvcc does
//     not contract into an FMA), then round to nearest even to bf16;
//     int32 -> float rounds to nearest as torch's cast does; ReLU and
//     max|out| (atomicMax on the float bits, zeroed by the launcher) on the
//     bf16 values; the tile staged through shared memory and stored along
//     the positions, coalesced.
// |acc| <= 127^2 * K < 2^31 for K <= 133,000 (the flagship's largest K is
// 512 * 4^3 = 32,768).

#include <cstring>
#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int kFill = 4;           // halo items a producer thread keeps in flight
constexpr int kMaxTaps = 343;      // k <= 7
constexpr int kGeometryError = 3000;   // the direct kernel was asked for a shape it does not take
// the gather kernel
constexpr int kBK = 128;           // bytes of K per tile: one 128-byte swizzle row
constexpr int kStages = 4;         // depth of its ring
// the direct kernel.  The PART_* macros are for scripts/int8_kernel_parts.py,
// which times builds with one part switched off; the library defines none.
#ifndef PART_TAPS_PER_STAGE
#define PART_TAPS_PER_STAGE 2
#endif
#ifndef PART_IN_FLIGHT
#define PART_IN_FLIGHT 2
#endif
constexpr int kBKD = 64;           // bytes of K per tap's B tile
constexpr int kTapsPerStage = PART_TAPS_PER_STAGE;  // taps of one B stage and one wgmma group
constexpr int kMaxRing = 16;       // depth of the B ring, at most
constexpr int kFillers = 96;       // producer threads that fill the halo
constexpr int kInFlight = PART_IN_FLIGHT;  // committed wgmma groups left running

struct Shape {
  int C, D, H, W, S;  // input channels and volume; S = D * H * W
  long long M;        // output positions, B * S
  int cout, cin_p, k, pad, taps;
  int cw;             // channels per halo slice: min(cin_p, 128)
  int g;              // taps per K tile: 128 / cw
  int n_chunks, n_tgroups;
  int reach_lo, reach_hi;  // linear reach of a window below / above its cell
  int halo_cells;          // capacity of the halo
};

// The direct kernel's geometry: wgmma reads A straight from the halo.
// Tiles of whole z-planes of an 8 x 8 grid, the halo zero-padded (P planes of
// Hp x Wp cells) so that every tap is a plain shift.
struct Direct {
  int ok;          // 0 where the shape does not fit (then nothing launches)
  int P, Hp, Wp;
  int cw;          // channels per halo slice and K tile: 32 or 64
  int n_chunks;    // cin_p / cw
  int lbo;         // bytes between the halo's 16-channel groups (cells, 16 bytes each)
  int halo_bytes;  // one of the two halo buffers
  int stages;      // depth of the B ring
};

// A K-major tile without swizzle: core matrices of 8 rows x 16 bytes (128
// contiguous bytes), `sbo` bytes apart along M and `lbo` bytes apart along K.
__device__ __forceinline__ uint64_t plain_desc(const void* p, int lbo, int sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

template <int BN>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n"
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
        : "l"(a), "l"(b), "r"(1));
  }
};

// Quantizes n_items items of the activation into shared memory, with
// thread t of nthreads.  `item(i, src, ch, dst)` names item i: 8
// consecutive input cells from the linear cell src (b * S + p) and the 4
// channels from ch; word e (4 int8 channels of cell src + e) goes to
// dst + e * step.  Cells at or past M and channels at or past C read 0 (the
// channel tail).  kFill items are loaded before any is quantized, so their
// loads overlap; a value near a tie is reloaded and divided exactly.
template <typename Item>
__device__ __forceinline__ void fill_items(int n_items, int t, int nthreads, int step, Item item,
                                           const __nv_bfloat16* __restrict__ x,
                                           const Shape& sh, float s_x, float inv_s) {
  const int M = static_cast<int>(sh.M);
  const bool vec = sh.S % 8 == 0;
  const uint16_t* xh = reinterpret_cast<const uint16_t*>(x);
  for (int base = 0; base < n_items; base += kFill * nthreads) {
    uint4 raw[kFill][4];
#pragma unroll
    for (int f = 0; f < kFill; ++f) {
      const int it = base + f * nthreads + t;
      int src = M, ch = 0;
      uint8_t* dst;
      if (it < n_items) item(it, src, ch, dst);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        raw[f][u] = make_uint4(0, 0, 0, 0);
        if (ch + u >= sh.C || src >= M) continue;  // zeros
        if (vec) {
          const int b = src / sh.S, p = src - b * sh.S;
          raw[f][u] = __ldg(reinterpret_cast<const uint4*>(
              x + (static_cast<long long>(b) * sh.C + ch + u) * sh.S + p));
        } else {
          uint32_t h[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int cell = src + e, b = cell / sh.S, p = cell - b * sh.S;
            h[e] = cell < M ? __ldg(xh + (static_cast<long long>(b) * sh.C + ch + u) * sh.S + p)
                            : 0u;
          }
          raw[f][u] = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                                 h[6] | (h[7] << 16));
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kFill; ++f) {
      const int it = base + f * nthreads + t;
      if (it >= n_items) continue;
      int src, ch;
      uint8_t* dst;
      item(it, src, ch, dst);
      uint32_t packed[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      uint32_t near_mask = 0;  // bit 8 u + e: value (u, e) lies near a tie
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t w[4] = {raw[f][u].x, raw[f][u].y, raw[f][u].z, raw[f][u].w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          bool near;
          const float v = (e & 1) ? bf16_hi(w[e / 2]) : bf16_lo(w[e / 2]);
          packed[e] |= (quantize_fast(v, inv_s, near) & 0xFFu) << (8 * u);
          near_mask |= static_cast<uint32_t>(near) << (8 * u + e);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) *reinterpret_cast<uint32_t*>(dst + e * step) = packed[e];
      while (near_mask != 0) {  // rare: reload the value, divide, patch its byte
        const int bit = __ffs(near_mask) - 1, u = bit >> 3, e = bit & 7;
        near_mask &= near_mask - 1;
        const int cell = src + e, b = cell / sh.S, p = cell - b * sh.S;
        const float v = __bfloat162float(x[(static_cast<long long>(b) * sh.C + ch + u) * sh.S + p]);
        dst[e * step + u] = static_cast<uint8_t>(quantize_exact(v, s_x));
      }
    }
  }
}

// The epilogue of both kernels, run by the consumer warpgroups once their
// products are done: accumulator i of a thread sits at row 16 * warp +
// lane / 4 (+ 8 for i & 2) of its warpgroup's 64, column 8 * (i / 4) + 2 *
// (lane % 4) + (i & 1).  The tile is staged as [BN][BM + 8] bf16 in `stage`
// (the ring, free once every consumer is past its last product) and stored
// along the positions: consecutive threads, consecutive cells.
template <int BM, int BN>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2], uint8_t* stage,
                                           long long m0, int n0, float s_x,
                                           const float* __restrict__ s_w,
                                           const float* __restrict__ bias,
                                           __nv_bfloat16* __restrict__ out,
                                           float* __restrict__ out_amax, int relu,
                                           const Shape& sh) {
  constexpr int kConsumers = BM / 64;
  constexpr int kLd = BM + 8;
  const int tid = threadIdx.x, wg = tid / kWG;
  named_barrier(1, kConsumers * kWG);  // every consumer is done with the ring
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(stage);
  const int warp = (tid % kWG) / 32, lane = tid % 32;
  float local_max = 0.0f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int row = wg * 64 + warp * 16 + lane / 4 + ((i & 2) ? 8 : 0);
    const int col = (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
    const int n = n0 + col;
    float v = 0.0f;
    if (n < sh.cout) {
      const float scale = __fmul_rn(__ldg(s_w + n), s_x);
      v = __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), scale), __ldg(bias + n));
    }
    __nv_bfloat16 h = __float2bfloat16_rn(v);
    if (relu && __bfloat162float(h) < 0.0f) h = __float2bfloat16_rn(0.0f);
    if (n < sh.cout && m0 + row < sh.M) local_max = fmaxf(local_max, fabsf(__bfloat162float(h)));
    tile[col * kLd + row] = h;
  }
  named_barrier(1, kConsumers * kWG);
  const int row = tid % BM;
  const long long m = m0 + row;
  if (m < sh.M) {
    const long long b = m / sh.S, p = m - b * sh.S;
    __nv_bfloat16* o = out + b * sh.cout * static_cast<long long>(sh.S) + p;
    for (int col = tid / BM; col < BN; col += kConsumers * kWG / BM) {
      const int n = n0 + col;
      if (n < sh.cout) o[static_cast<long long>(n) * sh.S] = tile[col * kLd + row];
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

// The gather kernel: for the shapes the direct kernel does not take (k = 2
// and 4 on the 4^3 and 2^3 grids), the producer warpgroup quantizes the
// tile's halo per 128-channel slice, then gathers each K tile's rows from it
// into the ring's 128-byte-swizzled A stage; B by TMA into the same stage.
template <int BM, int BN>
__global__ void __launch_bounds__((BM / 64 + 1) * kWG, 1) int8_conv3d_kernel(
    const __grid_constant__ CUtensorMap w_map, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ x_amax, const float* __restrict__ s_w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    float* __restrict__ out_amax, int relu, const Shape sh) {
  constexpr int kConsumers = BM / 64;
  constexpr int kA = BM * kBK, kB = BN * kBK;  // bytes of a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sA = smem;
  uint8_t* sB = sA + kStages * kA;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + kStages * kB);
  uint64_t* empty = full + kStages;
  int2* taps = reinterpret_cast<int2*>(empty + kStages);
  uint8_t* halo = reinterpret_cast<uint8_t*>(taps + ((sh.taps + 1) & ~1));

  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int n_k = sh.n_chunks * sh.n_tgroups;
  const float s_x = __fdiv_rn(fmaxf(*x_amax, 1e-12f), 127.0f);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kWG / 32 + 1);        // a lane of each producer warp + the TMA
      mbar_init(&empty[s], kConsumers * kWG / 32);  // a lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---------------- producer warpgroup: A quantized and gathered, B by TMA
    const int pt = tid - kConsumers * kWG;
    const float inv_s = __frcp_rn(s_x);
    const int HW = sh.H * sh.W;
    for (int t = pt; t < sh.taps; t += kWG) {
      const int kd = t / (sh.k * sh.k), kh = (t / sh.k) % sh.k, kw = t % sh.k;
      const int dz = kd - sh.pad, dy = kh - sh.pad, dx = kw - sh.pad;
      taps[t] = make_int2(dz * HW + dy * sh.W + dx,
                          (dz & 0xFF) | ((dy & 0xFF) << 8) | ((dx & 0xFF) << 16));
    }
    // the halo: input cells [lo, hi), 8-aligned; cells at or past M read 0
    const int M = static_cast<int>(sh.M);
    const int lo = (static_cast<int>(m0) - sh.reach_lo > 0 ? static_cast<int>(m0) - sh.reach_lo
                                                            : 0) & ~7;
    int hi = static_cast<int>(m0) + BM + sh.reach_hi;
    hi = ((hi < M ? hi : M) + 7) & ~7;
    const int n_groups = (hi - lo) / 8;

    // this thread copies 16-byte chunk j of rows pt / 8 + 16 i of each A tile
    constexpr int kRows = BM / 16;
    const int j = pt % 8;
    int rz[kRows], ry[kRows], rx[kRows], rcell[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = static_cast<int>(m0) + pt / 8 + 16 * i;
      rcell[i] = -1;
      rz[i] = ry[i] = rx[i] = 0;
      if (m < M) {
        const int p = m % sh.S;
        rz[i] = p / HW;
        ry[i] = (p / sh.W) % sh.H;
        rx[i] = p % sh.W;
        rcell[i] = m - lo;
      }
    }
    const int quads = sh.cw / 4;

    int stage = 0;
    uint32_t phase = 0;
    for (int c = 0; c < sh.n_chunks; ++c) {
      named_barrier(2, kWG);  // the tap table is written; the last halo is read
      // item (8 cells from lo + 8 grp, channels 4 q..4 q + 3 of slice c) ->
      // halo rows of cw bytes
      fill_items(n_groups * quads, pt, kWG, sh.cw,
                 [&](int it, int& src, int& ch, uint8_t*& dst) {
                   const int q = it % quads, grp = it / quads;
                   src = lo + grp * 8;
                   ch = c * sh.cw + q * 4;
                   dst = halo + grp * 8 * sh.cw + q * 4;
                 },
                 x, sh, s_x, inv_s);
      named_barrier(2, kWG);  // the halo of slice c is complete

      for (int tg = 0; tg < sh.n_tgroups; ++tg) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (pt == 0) {
          mbar_arrive_expect_tx(&full[stage], kB);
          tma_load_2d(sB + stage * kB, &w_map, &full[stage],
                      tg * sh.g * sh.cin_p + c * sh.cw, n0);
        }
        const int o = j * 16;
        const int tap = tg * sh.g + o / sh.cw;
        const int ci = o % sh.cw;
        int off = 0, dz = 0, dy = 0, dx = 0;
        const bool tap_ok = tap < sh.taps;
        if (tap_ok) {
          const int2 tp = taps[tap];
          off = tp.x;
          dz = static_cast<int8_t>(tp.y & 0xFF);
          dy = static_cast<int8_t>((tp.y >> 8) & 0xFF);
          dx = static_cast<int8_t>((tp.y >> 16) & 0xFF);
        }
        uint8_t* a = sA + stage * kA;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = pt / 8 + 16 * i;
          const int z = rz[i] + dz, y = ry[i] + dy, xx = rx[i] + dx;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (tap_ok && rcell[i] >= 0 && z >= 0 && z < sh.D && y >= 0 && y < sh.H &&
              xx >= 0 && xx < sh.W)
            v = *reinterpret_cast<const uint4*>(halo + (rcell[i] + off) * sh.cw + ci);
          *reinterpret_cast<uint4*>(a + r * kBK + ((j ^ (r & 7)) << 4)) = v;
        }
        fence_proxy_async();  // the generic stores, visible to wgmma
        __syncwarp();
        if (pt % 32 == 0) mbar_arrive(&full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups: 64 rows of the tile each
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int stage = 0, prev = -1;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      mbar_wait(&full[stage], phase);
      wgmma_fence();
      const uint8_t* a = sA + stage * kA + wg * 64 * kBK;
      const uint8_t* b = sB + stage * kB;
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        Wgmma<BN>::mma(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();  // the previous tile's products are done: release it
      if (prev >= 0 && tid % 32 == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    store_tile<BM, BN>(acc, sA, m0, n0, s_x, s_w, bias, out, out_amax, relu, sh);
  }
}

// The direct kernel: for the 8 x 8 grids, where a core matrix of wgmma's A
// (8 rows x 16 bytes) is 8 consecutive cells of the padded halo, wgmma
// reads A straight from the quantized halo (no swizzle, 16-channel groups
// `lbo` bytes apart) and the gather copy is gone.  The halo is
// double-buffered per 32- or 64-channel slice (filled by producer warps 1-3
// while the consumers multiply the other slice), B comes by TMA in 64-byte
// K tiles through a ring up to 16 deep (producer warp 0, lane 0), one K
// tile per (slice, tap).
template <int BM, int BN>
__global__ void __launch_bounds__((BM / 64 + 1) * kWG, 1) int8_conv3d_direct_kernel(
    const __grid_constant__ CUtensorMap w_map, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ x_amax, const float* __restrict__ s_w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    float* __restrict__ out_amax, int relu, const Shape sh, const Direct dg) {
  constexpr int kConsumers = BM / 64;
  constexpr int kB = BN * kBKD;           // bytes of one tap's B tile
  constexpr int kS = kTapsPerStage * kB;  // bytes of a B stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sB = smem;
  uint64_t* bfull = reinterpret_cast<uint64_t*>(sB + dg.stages * kS);
  uint64_t* bempty = bfull + kMaxRing;
  uint64_t* hfull = bempty + kMaxRing;
  uint64_t* hempty = hfull + 2;
  uint8_t* halo = reinterpret_cast<uint8_t*>(hempty + 2);

  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const float s_x = __fdiv_rn(fmaxf(*x_amax, 1e-12f), 127.0f);

  if (tid == 0) {
    for (int s = 0; s < dg.stages; ++s) {
      mbar_init(&bfull[s], 1);
      mbar_init(&bempty[s], kConsumers * kWG / 32);  // a lane of each consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&hfull[s], kFillers / 32);  // a lane of each filler warp
      mbar_init(&hempty[s], kConsumers * kWG / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    const int pt = tid - kConsumers * kWG;
    if (pt == 0) {
      // ---------------- the B stream: 64-byte K tiles of up to two taps per stage
      int stage = 0;
      uint32_t phase = 0;
      for (int c = 0; c < dg.n_chunks; ++c) {
        for (int t = 0; t < sh.taps; t += kTapsPerStage) {
          const int n = sh.taps - t < kTapsPerStage ? sh.taps - t : kTapsPerStage;
          mbar_wait(&bempty[stage], phase ^ 1);
#ifdef PART_NO_B
          mbar_arrive(&bfull[stage]);
#else
          mbar_arrive_expect_tx(&bfull[stage], n * kB);
          for (int u = 0; u < n; ++u)
            tma_load_2d(sB + stage * kS + u * kB, &w_map, &bfull[stage],
                        (t + u) * sh.cin_p + c * dg.cw, n0);
#endif
          if (++stage == dg.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (pt >= 32) {
      // ---------------- warps 1-3: the quantized halo of each slice
      const int ft = pt - 32;
      const float inv_s = __frcp_rn(s_x);
      const int M = static_cast<int>(sh.M);
      // zero both buffers once: the padding cells are never written again
      for (int i = ft * 16; i < 2 * dg.halo_bytes; i += kFillers * 16)
        *reinterpret_cast<uint4*>(halo + i) = make_uint4(0, 0, 0, 0);
      named_barrier(2, kFillers);
      const int quads = dg.cw / 4;
      const int rows = dg.P * 8;  // runs of 8 cells: x-rows of the padded planes
      const int b = static_cast<int>(m0 / sh.S);
      const int z0 = static_cast<int>(m0 % sh.S) / 64;
      for (int c = 0; c < dg.n_chunks; ++c) {
        const int buf = c & 1;
        mbar_wait(&hempty[buf], ((c >> 1) & 1) ^ 1);
        uint8_t* hb = halo + buf * dg.halo_bytes;
#ifndef PART_NO_FILL
        fill_items(rows * quads, ft, kFillers, 16,
                   [&](int it, int& src, int& ch, uint8_t*& dst) {
                     // x-row (plane zp, row y) of the padded halo
                     const int q = it % quads, xr = it / quads;
                     const int zp = xr / 8, y = xr % 8, z = z0 - sh.pad + zp;
                     src = z >= 0 && z < sh.D ? b * sh.S + (z * 8 + y) * 8 : M;
                     const int cell = (zp * dg.Hp + y + sh.pad) * dg.Wp + sh.pad;
                     ch = c * dg.cw + q * 4;
                     dst = hb + (q / 4) * dg.lbo + cell * 16 + (q % 4) * 4;
                   },
                   x, sh, s_x, inv_s);
#endif
        fence_proxy_async();  // the generic stores, visible to wgmma
        __syncwarp();
        if (ft % 32 == 0) mbar_arrive(&hfull[buf]);
      }
    }
  } else {
    // ---------------- consumer warpgroups: 64 rows (one z-plane) each
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    // Descriptors advance by addition: the start address field counts 16
    // bytes, one halo cell.  The tap (kd, kh, kw) steps along its window
    // without divisions: the next kw is the next cell, the next kh the next
    // row, the next kd the next plane.
    const int sbo = dg.Wp * 16;
    const uint64_t a_group2 = static_cast<uint64_t>(2 * dg.lbo) >> 4;  // K step of 32 bytes
    const uint64_t b0 = sw64_desc(sB);
    const int row_skip = dg.Wp - sh.k, plane_skip = (dg.Hp - sh.k) * dg.Wp;
    int stage = 0, oldest = 0, pending = 0;  // pending: committed, not released
    uint32_t phase = 0;
    for (int c = 0; c < dg.n_chunks; ++c) {
      const int buf = c & 1;
      mbar_wait(&hfull[buf], (c >> 1) & 1);
      const uint64_t a0 = plain_desc(halo + buf * dg.halo_bytes, dg.lbo, sbo);
      int cell = wg * dg.Hp * dg.Wp, kh = 0, kw = 0;
      for (int t = 0; t < sh.taps; t += kTapsPerStage) {
        mbar_wait(&bfull[stage], phase);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < kTapsPerStage; ++u) {
          if (t + u == sh.taps) break;
          const uint64_t da = a0 + cell;
          const uint64_t db = b0 + static_cast<uint64_t>(stage * kS + u * kB) / 16;
#ifdef PART_NO_MMA
          (void)da; (void)db;
#else
          Wgmma<BN>::mma(acc, da, db);
          if (dg.cw == 64) Wgmma<BN>::mma(acc, da + a_group2, db + 2);
#endif
          ++cell;
          if (++kw == sh.k) {
            kw = 0;
            cell += row_skip;
            if (++kh == sh.k) {
              kh = 0;
              cell += plane_skip;
            }
          }
        }
        wgmma_commit();
        if (++pending > kInFlight) {  // the oldest tile's products are done: release it
          wgmma_wait<kInFlight>();
          if (tid % 32 == 0) mbar_arrive(&bempty[oldest]);
          oldest = oldest + 1 == dg.stages ? 0 : oldest + 1;
          --pending;
        }
        if (++stage == dg.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();  // every product reading this halo buffer is done
      for (; pending > 0; --pending) {
        if (tid % 32 == 0) mbar_arrive(&bempty[oldest]);
        oldest = oldest + 1 == dg.stages ? 0 : oldest + 1;
      }
      if (tid % 32 == 0) mbar_arrive(&hempty[buf]);
    }
    store_tile<BM, BN>(acc, sB, m0, n0, s_x, s_w, bias, out, out_amax, relu, sh);
  }
}

// The direct kernel's geometry for a bm-row tile, ok = 0 where it does not
// apply (ops/kernels/int8_cuda.py::kernel_for names the gather kernel there).
Direct direct_geometry(int bm, int bn, const Shape& sh) {
  Direct dg;
  dg.ok = 0;
  if (sh.cin_p % 32 != 0 || sh.k == 1 || sh.H != 8 || sh.W != 8 || sh.D % (bm / 64) != 0)
    return dg;
  dg.ok = 1;
  dg.P = bm / 64 + sh.k - 1;
  dg.Hp = dg.Wp = 8 + sh.k - 1;
  const int n_cells = dg.P * dg.Hp * dg.Wp;
  // 8 n + 1 cells between groups, so that the groups' words fall in other banks
  dg.lbo = ((n_cells + 6) / 8 * 8 + 1) * 16;
  dg.cw = sh.cin_p < kBKD ? sh.cin_p : kBKD;
  dg.n_chunks = sh.cin_p / dg.cw;
  dg.halo_bytes = dg.cw / 16 * dg.lbo;
  const long long left =
      kSmemMax - 1024 - (2 * kMaxRing + 4) * 8 - 2LL * dg.halo_bytes;
  const long long stage_bytes = static_cast<long long>(kTapsPerStage) * bn * kBKD;
  dg.stages = static_cast<int>(left / stage_bytes < kMaxRing ? left / stage_bytes : kMaxRing);
  // the epilogue's [bn][bm + 8] bf16 tile is staged in the ring
  if (dg.stages * stage_bytes < bn * (bm + 8) * 2 || dg.stages < 2) dg.ok = 0;
  return dg;
}

// The TMA map of w_q [cout, K] in boxes of (64 or 128 bytes of K) x bn rows,
// cached by everything it encodes: the weights of a served model are
// fixed, so each layer's map is encoded once.
int weight_map(CUtensorMap* map, const void* w_q, long long K, int cout, int bn, bool direct) {
  struct Entry {
    const void* ptr;
    long long K;
    int cout, bn;
    bool direct;
    CUtensorMap map;
  };
  static std::mutex lock;
  static Entry cache[256];
  static int n_cached = 0, next = 0;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n_cached; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == w_q && e.K == K && e.cout == cout && e.bn == bn && e.direct == direct) {
      std::memcpy(map, &e.map, sizeof(CUtensorMap));
      return 0;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(direct ? kBKD : kBK),
                             static_cast<cuuint32_t>(bn)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w_q),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              direct ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kTensorMapError + static_cast<int>(res);
  Entry& e = cache[next];
  e = Entry{w_q, K, cout, bn, direct, *map};
  next = (next + 1) % 256;
  if (n_cached < 256) ++n_cached;
  return 0;
}

size_t direct_smem_bytes(int bn, const Direct& dg) {
  return 1024 + static_cast<size_t>(dg.stages) * kTapsPerStage * bn * kBKD +
         (2 * kMaxRing + 4) * 8 +
         2 * static_cast<size_t>(dg.halo_bytes);
}

size_t smem_bytes(int bm, int bn, const Shape& sh) {
  return 1024 + static_cast<size_t>(kStages) * (bm + bn) * kBK + 2 * kStages * 8 +
         static_cast<size_t>((sh.taps + 1) & ~1) * 8 +
         static_cast<size_t>(sh.halo_cells) * sh.cw;
}

Shape make_shape(int B, int C, int D, int H, int W, int cin_p, int cout, int k, int pad,
                 int bm) {
  Shape sh;
  sh.C = C;
  sh.D = D;
  sh.H = H;
  sh.W = W;
  sh.S = D * H * W;
  sh.M = static_cast<long long>(B) * sh.S;
  sh.cout = cout;
  sh.cin_p = cin_p;
  sh.k = k;
  sh.pad = pad;
  sh.taps = k * k * k;
  sh.cw = cin_p < kBK ? cin_p : kBK;
  sh.g = kBK / sh.cw;
  sh.n_chunks = cin_p / sh.cw;
  sh.n_tgroups = (sh.taps + sh.g - 1) / sh.g;
  const int step = H * W + W + 1;
  sh.reach_lo = pad * step;
  sh.reach_hi = (k - 1 - pad) * step;
  sh.halo_cells = bm + sh.reach_lo + sh.reach_hi + 16;
  return sh;
}

template <int BM, int BN>
int launch_direct(const CUtensorMap& map, const void* x, const void* x_amax, const void* s_w,
                  const void* bias, void* out, void* out_amax, int relu, const Shape& sh,
                  const Direct& dg, cudaStream_t stream) {
  const size_t smem = direct_smem_bytes(BN, dg);
  if (smem > kSmemMax) return kSmemError;
  static const cudaError_t err = cudaFuncSetAttribute(
      int8_conv3d_direct_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sh.M + BM - 1) / BM),
                  static_cast<unsigned>((sh.cout + BN - 1) / BN));
  int8_conv3d_direct_kernel<BM, BN><<<grid, (BM / 64 + 1) * kWG, smem, stream>>>(
      map, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(x_amax),
      static_cast<const float*>(s_w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(out_amax), relu, sh, dg);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN>
int launch(const CUtensorMap& map, const void* x, const void* x_amax, const void* s_w,
           const void* bias, void* out, void* out_amax, int relu, const Shape& sh,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(BM, BN, sh);
  if (smem > kSmemMax) return kSmemError;
  static const cudaError_t err = cudaFuncSetAttribute(
      int8_conv3d_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sh.M + BM - 1) / BM),
                  static_cast<unsigned>((sh.cout + BN - 1) / BN));
  int8_conv3d_kernel<BM, BN><<<grid, (BM / 64 + 1) * kWG, smem, stream>>>(
      map, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(x_amax),
      static_cast<const float*>(s_w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(out_amax), relu, sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the fused int8 conv on `stream` with BM x BN output tiles (bm in
// {64, 128}, bn in {32, 64, 128}).  x bf16 [B, C, D, H, W]; w_q int8
// [cout, k^3, cin_p]; x_amax, the float32 bound the scale comes from;
// s_w, bias float32 [cout]; out bf16 [B, cout, D, H, W]; out_amax a
// float32 for max|out| (zeroed here, on the stream), or null; `direct` 1
// for the direct kernel, 0 for the gather kernel.  Returns 0 on success, a
// CUDA error code, 1000 + the CUresult of a failed weight tensor map, 2000
// where the tile would need more shared memory than a block has, or 3000
// where the direct kernel does not take the shape; allocates nothing and
// does not synchronise.  x and w_q 16-byte aligned.
int int8_conv3d_launch(const void* x, const void* w_q, const void* x_amax,
                       const void* s_w, const void* bias, void* out, void* out_amax,
                       int relu, int B, int C, int D, int H, int W, int cin_p, int cout,
                       int k, int pad, int bm, int bn, int direct, void* stream) {
  const bool cin_ok = cin_p == 16 || cin_p == 32 || cin_p == 64 ||
                      (cin_p > 0 && cin_p % 128 == 0);
  if (B < 0 || C <= 0 || C > cin_p || D <= 0 || H <= 0 || W <= 0 || cout <= 0 ||
      k <= 0 || k * k * k > kMaxTaps || !cin_ok || pad < 0 || pad >= k)
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Shape sh = make_shape(B, C, D, H, W, cin_p, cout, k, pad, bm);

  const Direct dg = direct_geometry(bm, bn, sh);
  if (direct && !dg.ok) return kGeometryError;

  CUtensorMap map;
  const int res = weight_map(&map, w_q, static_cast<long long>(sh.taps) * cin_p, cout, bn, direct);
  if (res != 0) return res;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_amax != nullptr) {
    const cudaError_t err = cudaMemsetAsync(out_amax, 0, sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (direct) {
    if (bm == 128 && bn == 128)
      return launch_direct<128, 128>(map, x, x_amax, s_w, bias, out, out_amax, relu, sh, dg, s);
    if (bm == 128 && bn == 64)
      return launch_direct<128, 64>(map, x, x_amax, s_w, bias, out, out_amax, relu, sh, dg, s);
    if (bm == 128 && bn == 32)
      return launch_direct<128, 32>(map, x, x_amax, s_w, bias, out, out_amax, relu, sh, dg, s);
    if (bm == 64 && bn == 128)
      return launch_direct<64, 128>(map, x, x_amax, s_w, bias, out, out_amax, relu, sh, dg, s);
    if (bm == 64 && bn == 64)
      return launch_direct<64, 64>(map, x, x_amax, s_w, bias, out, out_amax, relu, sh, dg, s);
    if (bm == 64 && bn == 32)
      return launch_direct<64, 32>(map, x, x_amax, s_w, bias, out, out_amax, relu, sh, dg, s);
    return cudaErrorInvalidValue;
  }
  if (bm == 128 && bn == 128)
    return launch<128, 128>(map, x, x_amax, s_w, bias, out, out_amax, relu, sh, s);
  if (bm == 128 && bn == 64)
    return launch<128, 64>(map, x, x_amax, s_w, bias, out, out_amax, relu, sh, s);
  if (bm == 128 && bn == 32)
    return launch<128, 32>(map, x, x_amax, s_w, bias, out, out_amax, relu, sh, s);
  if (bm == 64 && bn == 128)
    return launch<64, 128>(map, x, x_amax, s_w, bias, out, out_amax, relu, sh, s);
  if (bm == 64 && bn == 64)
    return launch<64, 64>(map, x, x_amax, s_w, bias, out, out_amax, relu, sh, s);
  if (bm == 64 && bn == 32)
    return launch<64, 32>(map, x, x_amax, s_w, bias, out, out_amax, relu, sh, s);
  return cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  if (code == kSmemError) return "the tile needs more shared memory than a block has";
  if (code == kGeometryError) return "the direct kernel does not take this shape";
  if (code >= kTensorMapError) return "cuTensorMapEncodeTiled failed for the weights";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
