// 3-D max pool with TensorFlow's SAME padding, forward only, for Hopper
// (sm_90a).
//
// Replaces: no Pallas kernel.  JAX runs this pool as XLA's reduce_window
// (nestinet_tpu/ops/nn.py:347, max_pool3d); on the card the port ran aten's
// max_pool3d_with_indices (F.max_pool3d) behind a -inf pad copy.  The plain
// PyTorch version, which the CPU and autograd keep, is
// nestinet_tpu_torch/ops/nn.py::max_pool3d_reference; this kernel equals it
// bit for bit:
//
//   out[n, od, oh, ow] = the first maximum over kd, kh, kw (in that order)
//                        of x[n, od*s - pd + kd, oh*s - ph + kh, ow*s - pw + kw]
//
// over the cells inside the grid (the pad is -inf and never wins), where a
// value replaces the current one when it is strictly greater or a NaN, as
// aten's loop does; the value is kept as its bits, so signed zeros and NaN
// payloads come out as aten's.  A max selects and never rounds.  Layouts: x
// [N, D, H, W] (NCDHW with N = B * C), out [N, OD, OH, OW], both contiguous,
// bfloat16 or float32; OD = ceil(D / s), the SAME pad's odd cell at the end.
//
// What bounds it on an H100: bytes.  The 8^3 pool of the manager at B = 256
// reads 201 MB and writes 25 MB, 67 us at 3.35 TB/s.  aten's kernel took
// 28x that (1.9 ms in 13 launches): it writes an int64 index beside every
// output, gives each (n, c, od) plane a block of which a 4 x 4, 2 x 2 or
// 1 x 1 plane keeps 16, 4 or 1 thread busy, and splits a call into
// launches of at most 65,535 planes.  The design:
//   * one launch a call, one thread an output row (n, od, oh): every thread
//     has OW outputs to compute on every plane size, and on small planes
//     (2^3, 4^3) a warp spans several (sample, channel) planes;
//   * max_pool3d_kernel is instantiated for the served rows (W, k, s) =
//     (8, 2, 2), (4, 2, 2), (2, 2, 2), (3, 3, 2) and (3, 2, 2): a thread
//     loads each of its k x k input rows whole, with the widest aligned
//     vector (an 8-cell bf16 row is one 16-byte load, and the rows a thread
//     reads at kh = 0 and 1 share a 32-byte sector), and which input cell
//     feeds which output is fixed at compile time, so a row costs one
//     compare for each output a cell feeds; its OW outputs leave in one
//     store (8 bytes for four bf16);
//   * max_pool3d_any_kernel takes every other shape with the same mapping,
//     element by element.
// No indices are written; nothing is allocated here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kNegInfBf16 = 0xFF80u;
constexpr uint32_t kNegInfF32 = 0xFF800000u;

// The SAME pad before the first cell of an axis of `size` cells.
__host__ __device__ constexpr int same_pad_lo(int size, int k, int s) {
  return ((size + s - 1) / s - 1) * s + k - size > 0
             ? (((size + s - 1) / s - 1) * s + k - size) / 2
             : 0;
}

// The widest vector, up to 16 bytes, whose size divides `bytes`.
__host__ __device__ constexpr int gcd16(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : bytes % 2 == 0 ? 2 : 1;
}

// The unsigned type of `Bytes` bytes: the vector a row is loaded or stored as.
template <int Bytes> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<2> { using T = uint16_t; };

// The value of a stored element: bfloat16 (uint16_t bits) or float32
// (uint32_t bits), exactly.
__device__ __forceinline__ float value(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}
__device__ __forceinline__ float value(uint32_t bits) { return __uint_as_float(bits); }

// aten's step: strictly greater, or a NaN, replaces.
template <typename U>
__device__ __forceinline__ void take(U bits, float& best, U& best_bits) {
  const float v = value(bits);
  if (v > best || v != v) {
    best = v;
    best_bits = bits;
  }
}

template <typename U>
__device__ __forceinline__ U neg_inf() {
  return static_cast<U>(sizeof(U) == 2 ? kNegInfBf16 : kNegInfF32);
}

// Output row r = (n OD + od) OH + oh, one a thread.
__device__ __forceinline__ void row_of(int r, int OD, int OH, long long& n, int& od, int& oh) {
  oh = r % OH;
  const int t = r / OH;
  od = t % OD;
  n = t / OD;
}

template <typename U, int W, int K, int S>
__global__ void __launch_bounds__(kThreads)
    max_pool3d_kernel(const U* __restrict__ x, U* __restrict__ out, int rows, int D, int H,
                      int OD, int OH, int pd, int ph) {
  constexpr int OW = (W + S - 1) / S;
  constexpr int PW = same_pad_lo(W, K, S);
  constexpr int kInBytes = gcd16(W * static_cast<int>(sizeof(U)));
  constexpr int kOutBytes = gcd16(OW * static_cast<int>(sizeof(U)));
  using In = typename Vec<kInBytes>::T;
  using Out = typename Vec<kOutBytes>::T;
  constexpr int kInVecs = W * static_cast<int>(sizeof(U)) / kInBytes;
  constexpr int kOutVecs = OW * static_cast<int>(sizeof(U)) / kOutBytes;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  long long n;
  int od, oh;
  row_of(r, OD, OH, n, od, oh);
  float best[OW];
  U best_bits[OW];
#pragma unroll
  for (int ow = 0; ow < OW; ++ow) {
    best_bits[ow] = neg_inf<U>();
    best[ow] = value(best_bits[ow]);
  }
#pragma unroll
  for (int kd = 0; kd < K; ++kd) {
    const int id = od * S - pd + kd;
    if (id < 0 || id >= D) continue;
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      const int ih = oh * S - ph + kh;
      if (ih < 0 || ih >= H) continue;
      const In* src = reinterpret_cast<const In*>(x + ((n * D + id) * H + ih) * W);
      In buf[kInVecs];
#pragma unroll
      for (int i = 0; i < kInVecs; ++i) buf[i] = __ldg(src + i);
      const U* cell = reinterpret_cast<const U*>(buf);
      // input cell iw feeds output ow where iw - (ow S - PW) lies in [0, K):
      // for each output, iw ascending is kw ascending
#pragma unroll
      for (int iw = 0; iw < W; ++iw) {
#pragma unroll
        for (int ow = 0; ow < OW; ++ow) {
          const int kw = iw - (ow * S - PW);
          if (kw >= 0 && kw < K) take(cell[iw], best[ow], best_bits[ow]);
        }
      }
    }
  }
  Out res[kOutVecs];
  U* res_cells = reinterpret_cast<U*>(res);
#pragma unroll
  for (int ow = 0; ow < OW; ++ow) res_cells[ow] = best_bits[ow];
  Out* dst = reinterpret_cast<Out*>(out + static_cast<long long>(r) * OW);
#pragma unroll
  for (int i = 0; i < kOutVecs; ++i) dst[i] = res[i];
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
    max_pool3d_any_kernel(const U* __restrict__ x, U* __restrict__ out, int rows, int D, int H,
                          int W, int OD, int OH, int OW, int K, int S, int pd, int ph, int pw) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  long long n;
  int od, oh;
  row_of(r, OD, OH, n, od, oh);
  for (int ow = 0; ow < OW; ++ow) {
    U best_bits = neg_inf<U>();
    float best = value(best_bits);
    for (int kd = 0; kd < K; ++kd) {
      const int id = od * S - pd + kd;
      if (id < 0 || id >= D) continue;
      for (int kh = 0; kh < K; ++kh) {
        const int ih = oh * S - ph + kh;
        if (ih < 0 || ih >= H) continue;
        const U* src = x + ((n * D + id) * H + ih) * W;
        for (int kw = 0; kw < K; ++kw) {
          const int iw = ow * S - pw + kw;
          if (iw >= 0 && iw < W) take(__ldg(src + iw), best, best_bits);
        }
      }
    }
    out[static_cast<long long>(r) * OW + ow] = best_bits;
  }
}

template <typename U, int W, int K, int S>
int launch_fixed(const void* x, void* out, int rows, int D, int H, int OD, int OH, int pd,
                 int ph, cudaStream_t stream) {
  max_pool3d_kernel<U, W, K, S><<<(rows + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const U*>(x), static_cast<U*>(out), rows, D, H, OD, OH, pd, ph);
  return static_cast<int>(cudaGetLastError());
}

template <typename U>
int launch(const void* x, void* out, long long N, int D, int H, int W, int k, int s, int fixed,
           cudaStream_t stream) {
  const int OD = (D + s - 1) / s, OH = (H + s - 1) / s, OW = (W + s - 1) / s;
  const int pd = same_pad_lo(D, k, s), ph = same_pad_lo(H, k, s), pw = same_pad_lo(W, k, s);
  if (N * OD * OH >= (1LL << 31)) return cudaErrorInvalidValue;
  const int rows = static_cast<int>(N * OD * OH);
  if (rows == 0) return 0;
  if (!fixed) {
    max_pool3d_any_kernel<U><<<(rows + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        static_cast<const U*>(x), static_cast<U*>(out), rows, D, H, W, OD, OH, OW, k, s, pd,
        ph, pw);
    return static_cast<int>(cudaGetLastError());
  }
  if (k == 2 && s == 2 && W == 8)
    return launch_fixed<U, 8, 2, 2>(x, out, rows, D, H, OD, OH, pd, ph, stream);
  if (k == 2 && s == 2 && W == 4)
    return launch_fixed<U, 4, 2, 2>(x, out, rows, D, H, OD, OH, pd, ph, stream);
  if (k == 2 && s == 2 && W == 2)
    return launch_fixed<U, 2, 2, 2>(x, out, rows, D, H, OD, OH, pd, ph, stream);
  if (k == 2 && s == 2 && W == 3)
    return launch_fixed<U, 3, 2, 2>(x, out, rows, D, H, OD, OH, pd, ph, stream);
  if (k == 3 && s == 2 && W == 3)
    return launch_fixed<U, 3, 3, 2>(x, out, rows, D, H, OD, OH, pd, ph, stream);
  return cudaErrorInvalidValue;  // no fixed-width instance of this row
}

}  // namespace

extern "C" {

// Launches the max pool on `stream`: x [N, D, H, W] -> out [N, OD, OH, OW],
// OD = ceil(D / s) and so on, both contiguous and 16-byte aligned, with
// N OD OH < 2^31 output rows; `bf16` 1 for bfloat16, 0 for float32; `fixed`
// 1 for max_pool3d_kernel's instance of the row (W, k, s)
// (cudaErrorInvalidValue where there is none), 0 for max_pool3d_any_kernel.
// Returns the CUDA error code of the launch (0 on success); allocates
// nothing and does not synchronise.
int max_pool3d_launch(const void* x, void* out, int bf16, long long N, int D, int H, int W,
                      int k, int s, int fixed, void* stream) {
  if (N < 0 || D <= 0 || H <= 0 || W <= 0 || k <= 0 || s <= 0) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<uint16_t>(x, out, N, D, H, W, k, s, fixed, st)
              : launch<uint32_t>(x, out, N, D, H, W, k, s, fixed, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
