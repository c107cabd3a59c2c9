// int8 implicit-GEMM SAME conv3d (and linear), stride 1, for Hopper (sm_90a).
//
// Replaces: nestinet_tpu/ops/quant.py::conv_nd_int8 (:85-126) and
// linear_int8 (:129-163), which JAX hands to XLA as an int8 convolution /
// dot with preferred_element_type=int32; PyTorch has no int8 conv3d on
// CUDA.  The plain PyTorch twin is
// nestinet_tpu_torch/ops/quant.py::int8_conv3d_reference.
//
//   acc[b, co, p] = sum over taps t and channels ci of
//                   x_q[b, p + offset(t), ci] * w_q[co, t, ci]    (int32)
//   out[b, co, p] = bf16( float(acc) * (s_w[co] * s_x) + bias[co] )
//
// as a GEMM with M = B*D*H*W output positions, N = cout and K = k^3 * cin_p
// (the A operand read through an im2col address map; cells outside the
// volume read 0, which is what zero-padding the float input gives, since
// quantization maps 0 to 0).  A linear is the same call with D = H = W = 1
// and k = 1.
//
// Layouts (ops/quant.py): x_q [B, D, H, W, cin_p] int8 and w_q [cout, k^3,
// cin_p] int8, cin_p a multiple of 16, so one K index (tap, ci) runs along
// contiguous bytes and every 16-byte segment of K lies inside one tap.  The
// output is bf16 NCDHW [B, cout, D, H, W].  The padding is TensorFlow's
// SAME for stride 1: `pad` cells before, k - 1 - pad after.
//
// What bounds it on an H100: at the flagship's widest convs (M = 131072 at
// B = 256 on the 8^3 grid, K up to 125 * 256) the int8 MACs, about 10^12
// operations per conv, against tens of MB moved: tensor-core work.  The
// design: a 64 x 64 output tile per block of 4 warps (each warp 32 x 32),
// K in slices of 64 bytes staged in shared memory by cp.async in a
// two-slice ring, the MACs on mma.sync m16n8k32 s8 x s8 -> s32.  Each
// thread keeps the decoded position of the A rows it loads and steps its
// (tap, channel) counter along K without divisions.  A wgmma/TMA design
// with a deeper ring is later work.
//
// The epilogue rounds in the plain version's order: s_w * s_x first, then
// a separate multiply and add (__fmul_rn / __fadd_rn, which nvcc does not
// contract into an FMA), then round to nearest even to bf16; int32 -> float
// rounds to nearest as torch's cast does.  |acc| <= 127^2 * K < 2^31 for
// K <= 133,000 (the flagship's largest K is 512 * 4^3 = 32,768).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;          // output positions per block
constexpr int kBN = 64;          // output channels per block
constexpr int kBK = 64;          // bytes of K per slice
constexpr int kRow = kBK + 16;   // shared row stride: conflict-free fragments
constexpr int kThreads = 128;    // 4 warps, 2 x 2 over the tile
constexpr int kSegs = kBK / 16;  // 16-byte segments per row and slice
constexpr int kLoads = kBM * kSegs / kThreads;  // A (and B) segments a thread copies

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Where one thread's 16-byte segment of the current K slice starts: tap
// (kd, kh, kw) and channel ci.  Advanced by kBK bytes per slice.
struct KCursor {
  int kd, kh, kw, ci;

  __device__ void init(int kk, int cin_p, int k) {
    const int tap = kk / cin_p;
    ci = kk - tap * cin_p;
    kd = tap / (k * k);
    kh = (tap / k) % k;
    kw = tap % k;
  }

  __device__ void advance(int cin_p, int k) {
    ci += kBK;
    while (ci >= cin_p) {
      ci -= cin_p;
      if (++kw == k) {
        kw = 0;
        if (++kh == k) {
          kh = 0;
          ++kd;
        }
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads) int8_conv3d_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ s_w, const float* __restrict__ s_x,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int B,
    int D, int H, int W, int cin_p, int cout, int k, int pad) {
  __shared__ __align__(16) int8_t sA[2][kBM * kRow];
  __shared__ __align__(16) int8_t sB[2][kBN * kRow];

  const int S = D * H * W;
  const long long M = static_cast<long long>(B) * S;
  const int K = k * k * k * cin_p;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int seg = tid % kSegs;

  // The A rows (output positions) and B rows (output channels) this thread
  // copies: row tid / kSegs + i * (kThreads / kSegs), segment `seg`.
  int pz[kLoads], py[kLoads], px[kLoads];
  long long pbase[kLoads];  // offset of the position's own cell in x
  bool prow[kLoads];
  const int8_t* wrow[kLoads];
  for (int i = 0; i < kLoads; ++i) {
    const int row = tid / kSegs + i * (kThreads / kSegs);
    const long long m = m0 + row;
    prow[i] = m < M;
    const long long mm = prow[i] ? m : 0;
    const long long b = mm / S;
    const int p = static_cast<int>(mm - b * S);
    pz[i] = p / (H * W);
    py[i] = (p / W) % H;
    px[i] = p % W;
    pbase[i] = mm * cin_p;
    const int n = n0 + row;
    wrow[i] = n < cout ? w + static_cast<long long>(n) * K : nullptr;
  }

  KCursor cur;
  cur.init(seg * 16, cin_p, k);
  int kk = seg * 16;

  auto load_slice = [&](int stage) {
    const bool k_ok = kk < K;
    const int dz = cur.kd - pad, dy = cur.kh - pad, dx = cur.kw - pad;
    const long long shift =
        ((static_cast<long long>(dz) * H + dy) * W + dx) * cin_p + cur.ci;
    for (int i = 0; i < kLoads; ++i) {
      const int row = tid / kSegs + i * (kThreads / kSegs);
      const int z = pz[i] + dz, y = py[i] + dy, xx = px[i] + dx;
      const bool va = k_ok && prow[i] && z >= 0 && z < D && y >= 0 && y < H &&
                      xx >= 0 && xx < W;
      cp_async_16(&sA[stage][row * kRow + seg * 16],
                  va ? x + pbase[i] + shift : x, va);
      const bool vb = k_ok && wrow[i] != nullptr;
      cp_async_16(&sB[stage][row * kRow + seg * 16], vb ? wrow[i] + kk : w,
                  vb);
    }
    kk += kBK;
    cur.advance(cin_p, k);
  };

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = (warp % 2) * 32, wn = (warp / 2) * 32;

  int acc[2][4][4];
  for (int mi = 0; mi < 2; ++mi)
    for (int ni = 0; ni < 4; ++ni)
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int n_slices = (K + kBK - 1) / kBK;
  load_slice(0);
  cp_async_commit();
  for (int s = 0; s < n_slices; ++s) {
    if (s + 1 < n_slices) load_slice((s + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();  // slice s has landed
    __syncthreads();
    const int8_t* a = sA[s & 1];
    const int8_t* bt = sB[s & 1];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* r0 = a + (wm + mi * 16 + g) * kRow + ks + t4 * 4;
        const int8_t* r8 = r0 + 8 * kRow;
        af[mi][0] = ld32(r0);
        af[mi][1] = ld32(r8);
        af[mi][2] = ld32(r0 + 16);
        af[mi][3] = ld32(r8 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* c0 = bt + (wn + ni * 8 + g) * kRow + ks + t4 * 4;
        bf[ni][0] = ld32(c0);
        bf[ni][1] = ld32(c0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }

  // Epilogue: accumulator r of fragment (mi, ni) sits at row g (+8 for
  // r >= 2), column 2 * t4 + (r & 1) of the warp's 16 x 8 piece.
  const float sx = *s_x;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long m = m0 + wm + mi * 16 + g + (r >= 2 ? 8 : 0);
      if (m >= M) continue;
      const long long b = m / S;
      const int p = static_cast<int>(m - b * S);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + ni * 8 + 2 * t4 + (r & 1);
        if (n >= cout) continue;
        const float scale = __fmul_rn(s_w[n], sx);
        const float v =
            __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][r]), scale), bias[n]);
        out[(b * cout + n) * S + p] = __float2bfloat16_rn(v);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the int8 conv on `stream`.  Returns the CUDA error code of the
// launch (0 on success); allocates nothing and does not synchronise.
// cin_p must be a positive multiple of 16 and x, w 16-byte aligned.
int int8_conv3d_launch(const void* x, const void* w, const void* s_w,
                       const void* s_x, const void* bias, void* out, int B,
                       int D, int H, int W, int cin_p, int cout, int k,
                       int pad, void* stream) {
  if (B < 0 || D <= 0 || H <= 0 || W <= 0 || cout <= 0 || k <= 0 ||
      cin_p <= 0 || cin_p % 16 != 0 || pad < 0 || pad >= k)
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const long long M = static_cast<long long>(B) * D * H * W;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((cout + kBN - 1) / kBN));
  int8_conv3d_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s_w), static_cast<const float*>(s_x),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), B, D,
      H, W, cin_p, cout, k, pad);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
