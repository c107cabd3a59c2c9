// 3-D average pool with TensorFlow's SAME padding, separable, forward only,
// for Hopper (sm_90a): the Inception block's pool branch at inference.
//
// Replaces: no Pallas kernel.  JAX runs this pool as XLA's reduce_window,
// one window sum per spatial axis (nestinet_tpu/ops/nn.py:394-414); on the
// card the port ran the same sums as aten ops, an F.pad (a fill and a copy)
// and k - 1 adds of strided views per axis, a divisor built from ones, a
// broadcast divide and, in the branch's cin > n order, a ReLU: about 30
// launches a pool at k = 3.  The plain PyTorch version, which the CPU and
// autograd keep, is nestinet_tpu_torch/ops/nn.py::avg_pool3d_reference; this
// kernel equals it bit for bit:
//
//   S1[od, h, w]   = sum over l = 0 .. k-1 of  x[od*s - pd + l, h, w]
//   S2[od, oh, w]  = sum over i = 0 .. k-1 of S1[od, oh*s - ph + i, w]
//   sum[od, oh, ow] = sum over j = 0 .. k-1 of S2[od, oh, ow*s - pw + j]
//   out = sum / (cD(od) cH(oh) cW(ow)),  then max(out, 0) unless NaN (relu)
//
// Each sum starts from its window's cell 0 and adds cells 1 .. k-1 in order,
// every add rounded to x.dtype; a cell outside the grid (the SAME pad) is +0
// and is added like any other, so -0 + pad = +0 as in the plain version.  The
// per-axis count c is the number of the window's cells inside the grid; the
// divisor is ((cD cH) cW), each product rounded to x.dtype (exact up to 256
// in bfloat16), and the quotient is aten's IEEE float32 divide rounded to
// x.dtype; then aten's ReLU, NaN kept, else fmaxf(v, 0), whose fmaxf(-0, +0)
// is +0 on the card.  A bfloat16 add is the native add.bf16 (__hadd, or
// __hadd2 on two cells where a row has an even number of them), which
// rounds the exact sum once; aten adds in float32 and rounds to bfloat16, and
// the two agree because float32 keeps more than 2 p + 2 bits of a
// bfloat16's p = 8 (double rounding is then innocuous).  On bfloat16 pairs
// the quotient is x times the correctly rounded 1 / c (see Lanes::divide),
// which has the same bits.  Layouts: x and out [N, D, H, W] (NCDHW with
// N = B * C), contiguous, bfloat16 or float32; OD = ceil(D / s).
//
// What bounds it on an H100: bytes.  The 256-channel 8^3 pool at B = 256
// reads 67.1 MB and writes 67.1 MB, 40 us at 3.35 TB/s; the separable aten
// form moved about 30 times that, in 30 launches (1.14 ms on an H100 at
// 700 W).  With an IEEE divide a cell and 8 KB a block this kernel ran at
// 37% of the bound there (45% adding two bfloat16 cells an instruction);
// dividing by a multiply and staging 16 KB a block, at 83% (89% at
// B = 1,024).  The design:
//   * avg_pool3d_kernel, for stride 1 and cubic grids of the served (R, k):
//     a block loads a run of whole (sample, channel) volumes, about 16 KB,
//     into shared memory with 16-byte loads, then each thread computes one
//     output row (n, d, h) of R cells at a time: it reads the k x k input
//     rows of its window as the widest aligned vectors (an 8-cell bfloat16
//     row is one 16-byte load), sums them over D, then over H, then along
//     the row over W with every offset fixed at compile time, divides by
//     the row's counts and stores the row with one vector store;
//   * avg_pool3d_any_kernel takes every other shape (strides above 1,
//     grids that are not cubic, other k): one thread an output cell, the
//     same sums read from global memory cell by cell.
// Nothing is allocated here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 16384;  // the input a block of the fixed kernel stages

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

template <int Bytes> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<2> { using T = uint16_t; };

// x.dtype's arithmetic on a stored cell: `T` the cell's type, `add` the
// add rounded to x.dtype, `rnd` a float32 rounded to x.dtype.
template <typename U> struct Cells;
template <> struct Cells<uint16_t> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T zero() { return __ushort_as_bfloat16(0); }
  static __device__ __forceinline__ T add(T a, T b) { return __hadd(a, b); }
  static __device__ __forceinline__ float value(T a) { return __bfloat162float(a); }
  static __device__ __forceinline__ T rnd(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Cells<uint32_t> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float value(T a) { return a; }
  static __device__ __forceinline__ T rnd(float v) { return v; }
};

// Cells of the window of output o inside an axis of `size` cells.
__host__ __device__ constexpr int valid_cells(int o, int size, int k, int s, int pad) {
  return (o * s - pad + k < size ? o * s - pad + k : size) - (o * s - pad > 0 ? o * s - pad : 0);
}

// aten's sums / counts in float32, then its ReLU, before the rounding to
// x.dtype: fmaxf(-0, +0) is +0, so max(round(q), 0) and round(max(q, 0))
// have the same bits.
__device__ __forceinline__ float quotient(float sum, float count, int relu) {
  const float q = __fdiv_rn(sum, count);
  return relu && q == q ? fmaxf(q, 0.0f) : q;
}

// Volumes a block of the fixed kernel stages: about kTileBytes, and a run
// whose bytes are a multiple of 16, so that every block's run starts aligned.
template <typename U, int R>
__host__ __device__ constexpr int vols_per_block() {
  constexpr int vol_bytes = R * R * R * static_cast<int>(sizeof(U));
  constexpr int align = 16 / gcd16(vol_bytes);
  constexpr int fit = kTileBytes / vol_bytes / align * align;
  return fit > align ? fit : align;
}

// A row of R cells in registers as lanes: two bfloat16 cells a lane
// (__nv_bfloat162, whose add __hadd2 rounds each half as __hadd does) where
// R is even, else one cell a lane.
template <typename U, int R, bool Pairs = sizeof(U) == 2 && R % 2 == 0>
struct Lanes {
  using C = Cells<U>;
  using L = typename C::T;
  static constexpr int kPer = 1;
  static __device__ __forceinline__ L zero() { return C::zero(); }
  static __device__ __forceinline__ L add(L a, L b) { return C::add(a, b); }
  // the lane of cells first .. first + kPer - 1 of the row, +0 outside it
  static __device__ __forceinline__ L at(const L (&row)[R], int first) {
    return first >= 0 && first < R ? row[first] : zero();
  }
  // the lane's quotient by `count`, with the ReLU where `relu`
  static __device__ __forceinline__ L divide(L sum, const int* count, int relu) {
    return C::rnd(quotient(C::value(sum), static_cast<float>(count[0]), relu));
  }
};
template <int R>
struct Lanes<uint16_t, R, true> {
  using L = __nv_bfloat162;
  static constexpr int kPer = 2;
  static __device__ __forceinline__ L zero() { return __bfloat162bfloat162(Cells<uint16_t>::zero()); }
  static __device__ __forceinline__ L add(L a, L b) { return __hadd2(a, b); }
  static __device__ __forceinline__ L at(const L (&row)[R / 2], int first) {
    if (first % 2 == 0 && first >= 0 && first + 1 < R) return row[first / 2];
    const __nv_bfloat16 z = Cells<uint16_t>::zero();
    const int a = first, b = first + 1;
    return __halves2bfloat162(a >= 0 && a < R ? (a % 2 ? row[a / 2].y : row[a / 2].x) : z,
                              b >= 0 && b < R ? (b % 2 ? row[b / 2].y : row[b / 2].x) : z);
  }
  // Both quotients as x * (1 / count), the reciprocal correctly rounded
  // (__frcp_rn), then rounded to bfloat16: for every bfloat16 x and every
  // integer count up to 1,024 this has the bits of aten's IEEE x / count
  // rounded to bfloat16 (a quotient of an 8-bit x by a count with an odd
  // factor lies at least 2^-14 of itself from a bfloat16 rounding boundary,
  // and the product's error is under 2^-23 of it; a power of two is exact).
  // Then aten's ReLU on the rounded quotients: NaN kept, else max(v, +0).
  static __device__ __forceinline__ L divide(L sum, const int* count, int relu) {
    const float2 v = __bfloat1622float2(sum);
    const L q = __floats2bfloat162_rn(v.x * __frcp_rn(static_cast<float>(count[0])),
                                      v.y * __frcp_rn(static_cast<float>(count[1])));
    return relu ? __hmax2_nan(q, zero()) : q;
  }
};

template <typename U, int R, int K>
__global__ void __launch_bounds__(kThreads)
    avg_pool3d_kernel(const U* __restrict__ x, U* __restrict__ out, long long N, int relu) {
  using Row = Lanes<U, R>;
  using L = typename Row::L;
  constexpr int kN = R / Row::kPer;  // lanes a row
  constexpr int kVol = R * R * R;
  constexpr int kRows = R * R;
  constexpr int kVols = vols_per_block<U, R>();
  constexpr int P = same_pad_lo(R, K, 1);
  static_assert(K * K * K <= 256, "the divisor is exact in bfloat16 up to 256");
  __shared__ __align__(16) U tile[kVols * kVol];

  const long long v0 = static_cast<long long>(blockIdx.x) * kVols;
  const int nv = static_cast<int>(N - v0 < kVols ? N - v0 : kVols);
  const int n_cells = nv * kVol;
  const U* src = x + v0 * kVol;
  const int n_vec = n_cells * static_cast<int>(sizeof(U)) / 16;
  for (int i = threadIdx.x; i < n_vec; i += kThreads)
    reinterpret_cast<uint4*>(tile)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
  for (int i = n_vec * 16 / static_cast<int>(sizeof(U)) + threadIdx.x; i < n_cells;
       i += kThreads)
    tile[i] = __ldg(src + i);
  __syncthreads();

  constexpr int kBytes = gcd16(R * static_cast<int>(sizeof(U)));
  using V = typename Vec<kBytes>::T;
  constexpr int kVecs = R * static_cast<int>(sizeof(U)) / kBytes;
  for (int r = threadIdx.x; r < nv * kRows; r += kThreads) {
    const int vol = r / kRows, d = r % kRows / R, h = r % R;
    // the rows of the window: D sums (S1) at h - P + i, summed over H (S2)
    L s2[kN];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int hh = h - P + i;
      L s1[kN];
#pragma unroll
      for (int m = 0; m < kN; ++m) s1[m] = Row::zero();
      if (hh >= 0 && hh < R) {
#pragma unroll
        for (int l = 0; l < K; ++l) {
          const int dd = d - P + l;
          V buf[kVecs];
          if (dd >= 0 && dd < R) {
            const V* row = reinterpret_cast<const V*>(tile + vol * kVol + dd * kRows + hh * R);
#pragma unroll
            for (int v = 0; v < kVecs; ++v) buf[v] = row[v];
          } else {
#pragma unroll
            for (int v = 0; v < kVecs; ++v) buf[v] = V();
          }
          const L* cells = reinterpret_cast<const L*>(buf);
#pragma unroll
          for (int m = 0; m < kN; ++m) s1[m] = l == 0 ? cells[m] : Row::add(s1[m], cells[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < kN; ++m) s2[m] = i == 0 ? s1[m] : Row::add(s2[m], s1[m]);
    }
    // the W sums lane by lane, each from its window's cell 0, then the divide
    const int cdh = valid_cells(d, R, K, 1, P) * valid_cells(h, R, K, 1, P);
    V res[kVecs];
    L* res_lanes = reinterpret_cast<L*>(res);
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      L sum = Row::at(s2, m * Row::kPer - P);
#pragma unroll
      for (int j = 1; j < K; ++j) sum = Row::add(sum, Row::at(s2, m * Row::kPer - P + j));
      int count[Row::kPer];
#pragma unroll
      for (int c = 0; c < Row::kPer; ++c)
        count[c] = cdh * valid_cells(m * Row::kPer + c, R, K, 1, P);
      res_lanes[m] = Row::divide(sum, count, relu);
    }
    V* dst = reinterpret_cast<V*>(out + v0 * kVol + static_cast<long long>(r) * R);
#pragma unroll
    for (int v = 0; v < kVecs; ++v) dst[v] = res[v];
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
    avg_pool3d_any_kernel(const U* __restrict__ x, U* __restrict__ out, long long cells, int D,
                          int H, int W, int OD, int OH, int OW, int K, int S, int pd, int ph,
                          int pw, int relu) {
  using C = Cells<U>;
  using T = typename C::T;
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= cells) return;
  const int ow = static_cast<int>(c % OW);
  const int oh = static_cast<int>(c / OW % OH);
  const int od = static_cast<int>(c / OW / OH % OD);
  const long long n = c / OW / OH / OD;
  const T* xn = reinterpret_cast<const T*>(x) + n * D * H * W;
  T sum = C::zero();
  for (int j = 0; j < K; ++j) {
    const int w = ow * S - pw + j;
    T s2 = C::zero();
    if (w >= 0 && w < W) {
      for (int i = 0; i < K; ++i) {
        const int h = oh * S - ph + i;
        T s1 = C::zero();
        if (h >= 0 && h < H) {
          for (int l = 0; l < K; ++l) {
            const int d = od * S - pd + l;
            const T cell = d >= 0 && d < D ? xn[(static_cast<long long>(d) * H + h) * W + w]
                                           : C::zero();
            s1 = l == 0 ? cell : C::add(s1, cell);
          }
        }
        s2 = i == 0 ? s1 : C::add(s2, s1);
      }
    }
    sum = j == 0 ? s2 : C::add(sum, s2);
  }
  // the divisor ((cD cH) cW), each product rounded to x.dtype, as aten multiplies
  const float cdh = C::value(C::rnd(static_cast<float>(valid_cells(od, D, K, S, pd) *
                                                       valid_cells(oh, H, K, S, ph))));
  const float count = C::value(C::rnd(cdh * static_cast<float>(valid_cells(ow, W, K, S, pw))));
  reinterpret_cast<T*>(out)[c] = C::rnd(quotient(C::value(sum), count, relu));
}

template <typename U, int R, int K>
int launch_fixed(const void* x, void* out, long long N, int relu, cudaStream_t stream) {
  constexpr int kVols = vols_per_block<U, R>();
  const long long blocks = (N + kVols - 1) / kVols;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  avg_pool3d_kernel<U, R, K><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const U*>(x), static_cast<U*>(out), N, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename U>
int launch(const void* x, void* out, long long N, int D, int H, int W, int k, int s, int relu,
           int fixed, cudaStream_t stream) {
  const int OD = (D + s - 1) / s, OH = (H + s - 1) / s, OW = (W + s - 1) / s;
  const long long cells = N * OD * OH * OW;
  if (cells == 0) return 0;
  if (!fixed) {
    const long long blocks = (cells + kThreads - 1) / kThreads;
    if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
    avg_pool3d_any_kernel<U><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const U*>(x), static_cast<U*>(out), cells, D, H, W, OD, OH, OW, k, s,
        same_pad_lo(D, k, s), same_pad_lo(H, k, s), same_pad_lo(W, k, s), relu);
    return static_cast<int>(cudaGetLastError());
  }
  if (s != 1 || D != H || H != W) return cudaErrorInvalidValue;
  if (W == 8 && k == 3) return launch_fixed<U, 8, 3>(x, out, N, relu, stream);
  if (W == 8 && k == 1) return launch_fixed<U, 8, 1>(x, out, N, relu, stream);
  if (W == 4 && k == 3) return launch_fixed<U, 4, 3>(x, out, N, relu, stream);
  if (W == 4 && k == 2) return launch_fixed<U, 4, 2>(x, out, N, relu, stream);
  if (W == 2 && k == 2) return launch_fixed<U, 2, 2>(x, out, N, relu, stream);
  if (W == 2 && k == 1) return launch_fixed<U, 2, 1>(x, out, N, relu, stream);
  if (W == 3 && k == 2) return launch_fixed<U, 3, 2>(x, out, N, relu, stream);
  if (W == 3 && k == 1) return launch_fixed<U, 3, 1>(x, out, N, relu, stream);
  return cudaErrorInvalidValue;  // no fixed instance of this volume
}

}  // namespace

extern "C" {

// Launches the average pool on `stream`: x [N, D, H, W] -> out [N, OD, OH,
// OW], OD = ceil(D / s) and so on, both contiguous and 16-byte aligned;
// `bf16` 1 for bfloat16, 0 for float32; `relu` 1 to apply aten's ReLU to
// the quotient; `fixed` 1 for avg_pool3d_kernel's instance of the cubic
// volume (R, k) at stride 1 (cudaErrorInvalidValue where there is none), 0
// for avg_pool3d_any_kernel.  Returns the CUDA error code of the launch (0
// on success); allocates nothing and does not synchronise.
int avg_pool3d_launch(const void* x, void* out, int bf16, long long N, int D, int H, int W,
                      int k, int s, int relu, int fixed, void* stream) {
  if (N < 0 || D <= 0 || H <= 0 || W <= 0 || k <= 0 || s <= 0) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<uint16_t>(x, out, N, D, H, W, k, s, relu, fixed, st)
              : launch<uint32_t>(x, out, N, D, H, W, k, s, relu, fixed, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
