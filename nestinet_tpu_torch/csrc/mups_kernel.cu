// MuPS 3DmFV statistics with zero-padding compensation, for Hopper (sm_90a).
//
// Replaces: nestinet_tpu/ops/pallas/mups_kernel.py::_kernel (launched by
// _forward, exposed as tdmfv_n_est_pallas).  The plain PyTorch twin is
// nestinet_tpu_torch/ops/mups.py::tdmfv_n_est_reference; both compute
// nestinet_tpu/ops/mups.py::tdmfv_n_est for one row (patch x scale) each:
//
//   s      = (p - mu) / sigma                       per point n, Gaussian k
//   wp     = coef_k * exp(-|s|^2 / 2) * w_k,  coef_k = 1 / ((2 pi)^1.5 sigma_k0^3)
//   q      = wp / sum_k wp                           (soft assignment)
//   rows n > n_eff are masked: q = 0 and d_pi = 0 there, yet they still
//   enter every max/min as zeros; the row at index n_eff counts as real
//   20 reductions over n: d_pi = (q - w)/sqrt(w) max,sum; q*s max,min,sum
//   and q*(s^2 - 1) max,min,sum per axis; rows scaled by 1, 1/sqrt(w),
//   1/sqrt(2w); / max(n_eff, 1); signed sqrt; L2 over k per channel.
//
// Output row order: pi(max,sum), mu_max xyz, mu_min xyz, mu_sum xyz,
// sig_max xyz, sig_min xyz, sig_sum xyz, as [R, 20, K].
//
// What bounds it on an H100: arithmetic, not memory.  At the flagship
// shape (N = 512 points, K = 512 Gaussians) a row needs 2*N*K = 524288
// exponentials and about 70*N*K FP32 operations, against 6 KB read and
// 40 KB written; 384 rows (B = 128, 3 scales) move 18 MB, about 5 us of
// HBM time, while the FP32 work is several hundred microseconds at the
// card's FMA and SFU rates.
//
// What the design does about it: one block per row keeps everything a row
// touches on chip.  The points, the Gaussians' constants and the per-point
// sum_k wp live in shared memory (27 KB at the flagship shape); each
// thread owns one Gaussian and keeps its 20 accumulators in registers, so
// nothing but the final [20, K] tile is written.  Masked rows are never
// evaluated: they fold in as one max/min against zero.  No fast-math and
// no FMA contraction (see below): the kernel buys agreement with the plain
// version at atol 1e-5 with IEEE divisions it could otherwise avoid.
// Making it fast (fewer exponentials and divisions, a better wave count)
// is later work.  tdmfv_n_est_blocked_kernel below is the several-rows-
// per-block variant.

#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 20;
constexpr int kMaxThreads = 1024;
constexpr int kWarp = 32;
// (2 pi)^(3/2): the pdf normaliser of a 3-D isotropic Gaussian.
constexpr float kTwoPiPow1p5 = 15.749609945722419f;

__device__ __forceinline__ float signed_sqrt(float x) {
  // sign(0) = 0, as jnp.sign.
  return x > 0.f ? sqrtf(x) : (x < 0.f ? -sqrtf(-x) : 0.f);
}

// The arithmetic below rounds after every operation, in the plain
// version's order, with IEEE division: the __f*_rn intrinsics keep nvcc
// from contracting a*b + c into one FMA.  Near zero the signed square root
// magnifies a one-ulp difference (d sqrt(x) = dx / (2 sqrt(x))), so the
// kernel matches the plain version's rounding wherever it can.  The long
// sums (over K for the denominator, over N for the statistics) cannot be
// taken in the plain version's order; both accumulate them in double, so
// the order no longer shows.  In float32 it did: the d_pi sum cancels to
// near zero for some Gaussians, and two summation orders differed there
// by more than 1e-5 after the square root.

// (p - mu) / sigma
__device__ __forceinline__ float scaled(float p, float m, float sg) {
  return __fdiv_rn(__fsub_rn(p, m), sg);
}

// coef * exp(-0.5 * |s|^2) * w
__device__ __forceinline__ float weighted_pdf(float sx, float sy, float sz,
                                              float coef, float w) {
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)),
                             __fmul_rn(sz, sz));
  return __fmul_rn(__fmul_rn(coef, expf(__fmul_rn(-0.5f, d2))), w);
}

// The Gaussians' constants of one block: mu, sigma, the pdf coefficient
// and w (8 K floats), loaded once per block.
struct Gaussians {
  const float* mu;    // [K, 3]
  const float* sig;   // [K, 3]
  const float* coef;  // [K]
  const float* w;     // [K]
};

// Shared memory of one block: [N, 3] points, [N] denominators, the
// Gaussians' constants (8 K), [20, 32] per-warp sums, [20] norms.
__host__ __device__ constexpr size_t smem_floats(int N, int K) {
  return 4 * static_cast<size_t>(N) + 8 * static_cast<size_t>(K) +
         kChannels * kWarp + kChannels;
}

__device__ Gaussians load_gaussians(float* smem, int N, int K,
                                    const float* __restrict__ w,
                                    const float* __restrict__ mu,
                                    const float* __restrict__ sigma) {
  float* s_mu = smem + 4 * N;
  float* s_sig = s_mu + 3 * K;
  float* s_coef = s_sig + 3 * K;
  float* s_w = s_coef + K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    for (int d = 0; d < 3; ++d) {
      s_mu[3 * k + d] = mu[3 * k + d];
      s_sig[3 * k + d] = sigma[3 * k + d];
    }
    const float s0 = sigma[3 * k];
    s_coef[k] = __fdiv_rn(
        1.0f, __fmul_rn(kTwoPiPow1p5, __fmul_rn(__fmul_rn(s0, s0), s0)));
    s_w[k] = w[k];
  }
  return Gaussians{s_mu, s_sig, s_coef, s_w};
}

// The [20, K] statistics of one row, computed by the whole block.  Every
// thread of the block calls it (it synchronises); the caller has stored the
// Gaussians' constants in shared memory, and the first synchronisation
// below publishes them with the points.  Back-to-back calls need no barrier
// in between: a thread starts the next row only after the last barrier
// here, which every thread reaches after its reads of the points and
// denominators, and every shared array is next written only after a
// barrier that follows all its reads.  Both kernels compute each row
// through this function, so their outputs are identical.
__device__ void row_stats(const float* __restrict__ pts,  // [N, 3]
                          const int ne, const Gaussians g, float* smem,
                          float* __restrict__ o,  // [20, K]
                          int N, int K) {
  float* s_pts = smem;                               // [N, 3]
  float* s_den = s_pts + 3 * N;                      // [N]   sum_k wp
  float* s_red = smem + smem_floats(N, K) - kChannels * kWarp - kChannels;
  float* s_norm = s_red + kChannels * kWarp;         // [20]
  const float* s_mu = g.mu;
  const float* s_sig = g.sig;
  const float* s_coef = g.coef;
  const float* s_w = g.w;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int last = min(ne, N - 1);  // rows 0..last are real (mask n <= n_eff)
  const float eff = static_cast<float>(max(ne, 1));

  for (int i = tid; i < 3 * N; i += nthreads) s_pts[i] = pts[i];
  __syncthreads();

  // Pass 1: threads over points, the soft-assignment denominator of each.
  for (int n = tid; n <= last; n += nthreads) {
    const float px = s_pts[3 * n], py = s_pts[3 * n + 1], pz = s_pts[3 * n + 2];
    double den = 0.0;
    for (int k = 0; k < K; ++k) {
      const float sx = scaled(px, s_mu[3 * k], s_sig[3 * k]);
      const float sy = scaled(py, s_mu[3 * k + 1], s_sig[3 * k + 1]);
      const float sz = scaled(pz, s_mu[3 * k + 2], s_sig[3 * k + 2]);
      den += weighted_pdf(sx, sy, sz, s_coef[k], s_w[k]);
    }
    s_den[n] = static_cast<float>(den);
  }
  __syncthreads();

  // Pass 2: thread k accumulates the 20 statistics of Gaussian k.
  const int k = tid;
  float v[kChannels];
  if (k < K) {
    const float mx = s_mu[3 * k], my = s_mu[3 * k + 1], mz = s_mu[3 * k + 2];
    const float sgx = s_sig[3 * k], sgy = s_sig[3 * k + 1], sgz = s_sig[3 * k + 2];
    const float coef = s_coef[k];
    const float wk = s_w[k];
    const float rsw = rsqrtf(wk);
    float pi_max = -INFINITY;
    double pi_sum = 0.0;
    float mu_max[3] = {-INFINITY, -INFINITY, -INFINITY};
    float mu_min[3] = {INFINITY, INFINITY, INFINITY};
    double mu_sum[3] = {0.0, 0.0, 0.0};
    float sg_max[3] = {-INFINITY, -INFINITY, -INFINITY};
    float sg_min[3] = {INFINITY, INFINITY, INFINITY};
    double sg_sum[3] = {0.0, 0.0, 0.0};
    for (int n = 0; n <= last; ++n) {
      float s[3];
      s[0] = scaled(s_pts[3 * n], mx, sgx);
      s[1] = scaled(s_pts[3 * n + 1], my, sgy);
      s[2] = scaled(s_pts[3 * n + 2], mz, sgz);
      const float wp = weighted_pdf(s[0], s[1], s[2], coef, wk);
      const float q = __fdiv_rn(wp, s_den[n]);
      const float dpi = __fmul_rn(__fsub_rn(q, wk), rsw);
      pi_max = fmaxf(pi_max, dpi);
      pi_sum += dpi;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float a = __fmul_rn(q, s[d]);
        const float b = __fmul_rn(q, __fsub_rn(__fmul_rn(s[d], s[d]), 1.0f));
        mu_max[d] = fmaxf(mu_max[d], a);
        mu_min[d] = fminf(mu_min[d], a);
        mu_sum[d] += a;
        sg_max[d] = fmaxf(sg_max[d], b);
        sg_min[d] = fminf(sg_min[d], b);
        sg_sum[d] += b;
      }
    }
    if (last < N - 1) {
      // Masked rows contribute exact zeros to every max/min (and nothing
      // to the sums).
      pi_max = fmaxf(pi_max, 0.f);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        mu_max[d] = fmaxf(mu_max[d], 0.f);
        mu_min[d] = fminf(mu_min[d], 0.f);
        sg_max[d] = fmaxf(sg_max[d], 0.f);
        sg_min[d] = fminf(sg_min[d], 0.f);
      }
    }
    const float rs2w = rsqrtf(__fmul_rn(2.0f, wk));
    v[0] = pi_max;
    v[1] = static_cast<float>(pi_sum);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      v[2 + d] = __fmul_rn(mu_max[d], rsw);
      v[5 + d] = __fmul_rn(mu_min[d], rsw);
      v[8 + d] = __fmul_rn(static_cast<float>(mu_sum[d]), rsw);
      v[11 + d] = __fmul_rn(sg_max[d], rs2w);
      v[14 + d] = __fmul_rn(sg_min[d], rs2w);
      v[17 + d] = __fmul_rn(static_cast<float>(sg_sum[d]), rs2w);
    }
#pragma unroll
    for (int c = 0; c < kChannels; ++c) v[c] = signed_sqrt(__fdiv_rn(v[c], eff));
  } else {
#pragma unroll
    for (int c = 0; c < kChannels; ++c) v[c] = 0.f;
  }

  // L2 over the Gaussians, per channel: warp sums, then across warps.
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int nwarps = nthreads / kWarp;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    float sq = __fmul_rn(v[c], v[c]);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      sq = __fadd_rn(sq, __shfl_down_sync(0xffffffffu, sq, off));
    }
    if (lane == 0) s_red[c * kWarp + warp] = sq;
  }
  __syncthreads();
  if (tid < kChannels) {
    float total = 0.f;
    for (int i = 0; i < nwarps; ++i) total += s_red[tid * kWarp + i];
    s_norm[tid] = rsqrtf(fmaxf(total, 1e-12f));
  }
  __syncthreads();

  if (k < K) {
#pragma unroll
    for (int c = 0; c < kChannels; ++c) o[c * K + k] = __fmul_rn(v[c], s_norm[c]);
  }
}

// One block per row.
__global__ void __launch_bounds__(kMaxThreads)
tdmfv_n_est_kernel(const float* __restrict__ points,  // [R, N, 3]
                   const int* __restrict__ n_eff,     // [R]
                   const float* __restrict__ w,       // [K]
                   const float* __restrict__ mu,      // [K, 3]
                   const float* __restrict__ sigma,   // [K, 3]
                   float* __restrict__ out,           // [R, 20, K]
                   int N, int K) {
  extern __shared__ float smem[];
  const int r = blockIdx.x;
  const Gaussians g = load_gaussians(smem, N, K, w, mu, sigma);
  row_stats(points + static_cast<size_t>(r) * N * 3, n_eff[r], g, smem,
            out + static_cast<size_t>(r) * kChannels * K, N, K);
}

// Replaces scripts/mups_kernel_exp.py::_kernel_blocked (launched by
// forward_blocked): one block per `block_b` consecutive rows, R / block_b
// blocks.  The Gaussians' constants (8 K floats, 16 KB at K = 512) are
// loaded into shared memory once per block, and the block walks its rows
// in a loop, which stands in for the TPU program's sequential
// `for j in range(block_b)`.  Bound, like the kernel above, by FP32 and
// SFU work, not by memory: a block saves only the reload of 16 KB per row.
// It also has fewer blocks: at R = 768 and block_b = 8 the grid is 96
// blocks on 132 SMs, so block_b > 1 trades parallelism for that reuse.
__global__ void __launch_bounds__(kMaxThreads)
tdmfv_n_est_blocked_kernel(const float* __restrict__ points,  // [R, N, 3]
                           const int* __restrict__ n_eff,     // [R]
                           const float* __restrict__ w,       // [K]
                           const float* __restrict__ mu,      // [K, 3]
                           const float* __restrict__ sigma,   // [K, 3]
                           float* __restrict__ out,           // [R, 20, K]
                           int N, int K, int block_b) {
  extern __shared__ float smem[];
  const Gaussians g = load_gaussians(smem, N, K, w, mu, sigma);
  for (int j = 0; j < block_b; ++j) {
    const int r = blockIdx.x * block_b + j;
    row_stats(points + static_cast<size_t>(r) * N * 3, n_eff[r], g, smem,
              out + static_cast<size_t>(r) * kChannels * K, N, K);
  }
}

// Threads and dynamic shared memory of a launch; raises the kernel's
// shared-memory limit above 48 KB when it needs more.
template <typename Kernel>
cudaError_t launch_shape(Kernel kernel, int N, int K, int* threads,
                         size_t* smem) {
  if (N <= 0 || K <= 0 || K > kMaxThreads) return cudaErrorInvalidValue;
  *threads = ((K + kWarp - 1) / kWarp) * kWarp;
  *smem = sizeof(float) * smem_floats(N, K);
  if (*smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches the one-row-per-block kernel on `stream` over R rows.  Returns
// the CUDA error code of the launch (0 on success); allocates nothing and
// does not synchronise.
int tdmfv_n_est_launch(const void* points, const void* n_eff, const void* w,
                       const void* mu, const void* sigma, void* out, int R,
                       int N, int K, void* stream) {
  if (R <= 0) return 0;
  int threads;
  size_t smem;
  const cudaError_t err = launch_shape(tdmfv_n_est_kernel, N, K, &threads, &smem);
  if (err != cudaSuccess) return err;
  tdmfv_n_est_kernel<<<R, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const int*>(n_eff),
      static_cast<const float*>(w), static_cast<const float*>(mu),
      static_cast<const float*>(sigma), static_cast<float*>(out), N, K);
  return static_cast<int>(cudaGetLastError());
}

// Launches the blocked kernel: R / block_b blocks of block_b rows each.
// R must be a multiple of block_b (cudaErrorInvalidValue otherwise).
int tdmfv_n_est_blocked_launch(const void* points, const void* n_eff,
                               const void* w, const void* mu,
                               const void* sigma, void* out, int R, int N,
                               int K, int block_b, void* stream) {
  if (block_b <= 0 || R % block_b != 0) return cudaErrorInvalidValue;
  if (R <= 0) return 0;
  int threads;
  size_t smem;
  const cudaError_t err =
      launch_shape(tdmfv_n_est_blocked_kernel, N, K, &threads, &smem);
  if (err != cudaSuccess) return err;
  tdmfv_n_est_blocked_kernel<<<R / block_b, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const int*>(n_eff),
      static_cast<const float*>(w), static_cast<const float*>(mu),
      static_cast<const float*>(sigma), static_cast<float*>(out), N, K,
      block_b);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
