// MuPS 3DmFV statistics with zero-padding compensation, for Hopper (sm_90a).
//
// Replaces: nestinet_tpu/ops/pallas/mups_kernel.py::_kernel (launched by
// _forward, exposed as tdmfv_n_est_pallas) with tdmfv_n_est_kernel, and
// scripts/mups_kernel_exp.py::_kernel_blocked (launched by forward_blocked)
// with tdmfv_n_est_blocked_kernel.  The plain PyTorch twin is
// nestinet_tpu_torch/ops/mups.py::tdmfv_n_est_reference; all compute
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
// What bounds it on an H100: instructions, not memory.  A row of 512 real
// points and 512 Gaussians is 262,144 (point, Gaussian) pairs; each needs
// one exponential (the MUFU pipe, 16 a clock per SM), about 47 float32
// instructions (128 a clock) and 8 float64 sums, against 6 KB read and
// 40 KB written per row.  What holds the kernel back from that is the
// denominators' reduction across the block, the float64 sums' conversions
// (16 a clock per SM) and latency: 127 registers a thread leave one block
// of 16 warps per SM.
//
// What the design does about it:
//   * one evaluation per pair: a block walks a row's real points in tiles
//     of kTile; each thread owns one Gaussian and keeps the tile's scaled
//     offsets and weighted pdfs in registers; each warp reduces the tile's
//     denominators sum_k wp in double by a reduce-scatter butterfly of
//     shuffles, every warp then adds the warps' partial sums itself (one
//     barrier a tile), and the same registers feed q and the 20 statistics;
//   * no full division per pair: every divisor is shared along a row or a
//     column (sigma_k by all points, the denominator by all Gaussians), so
//     the kernel takes one correctly rounded reciprocal per divisor and
//     corrects each quotient with one FMA (div_by below);
//   * the Gaussians' constants live in registers, the points in shared
//     memory as float4 (one broadcast 16-byte load per point);
//   * a persistent grid (SMs x the blocks per SM that the registers allow)
//     whose blocks take rows (kernel 1) or groups of block_b rows (blocked)
//     from a ticket counter, longest first, so that the wave does not end
//     on a long row; the last block to finish resets the counter, so each
//     call is one launch.
// Masked rows are never evaluated: they fold in as one max/min against
// zero.  No fast-math and no FMA contraction (see below).  The pdf
// coefficient is carried times 2^64 (kUp), so sigma_k0 must lie above
// about 2^-22, where that product is finite.
//
// Compile-time switches for timing only (scripts/mups_kernel_parts.py):
// PART_NO_EXP, PART_NO_DIV, PART_NO_SUMS and PART_NO_DEN switch a stage
// off (the output is then wrong), PART_NO_SORT hands the tickets out in
// row order and PART_TILE sets the tile.  None of them is set when the
// port builds the library.

#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 20;
constexpr int kWarp = 32;
// (2 pi)^(3/2): the pdf normaliser of a 3-D isotropic Gaussian.
constexpr float kTwoPiPow1p5 = 15.749609945722419f;
#ifndef PART_TILE
#define PART_TILE 8
#endif
constexpr int kTile = PART_TILE;  // points per tile, up to 512 Gaussians
constexpr int kWideTile = 2;      // up to 1024 Gaussians (64 registers)
// The weighted pdfs and their denominators are carried times 2^64 (the
// pdf coefficient is scaled once), so that the dividend of q's corrected
// division is never so small that its residual underflows; the quotient
// wp / den is the same.
constexpr float kUp = 0x1p64f;

__device__ __forceinline__ float signed_sqrt(float x) {
  // sign(0) = 0, as jnp.sign.
  return x > 0.f ? sqrtf(x) : (x < 0.f ? -sqrtf(-x) : 0.f);
}

// The arithmetic below rounds after every operation, in the plain
// version's order: the __f*_rn intrinsics keep nvcc from contracting
// a*b + c into one FMA.  Near zero the signed square root magnifies a
// one-ulp difference (d sqrt(x) = dx / (2 sqrt(x))), so the kernel matches
// the plain version's rounding wherever it can.  The long sums (over K for
// the denominator, over N for the statistics) cannot be taken in the plain
// version's order; both accumulate them in double, so the order no longer
// shows.  In float32 it did: the d_pi sum cancels to near zero for some
// Gaussians, and two summation orders differed there by more than 1e-5
// after the square root.

// a / b from r = RN(1 / b), rounded as IEEE division rounds (Markstein):
// q0 = RN(a r) is within two ulps of a / b, the FMA gives its residual
// a - q0 b exactly, and RN(q0 + residual * r) is the correctly rounded
// quotient.  This holds while the residual does not underflow (|a| above
// about 2^-100) and the quotient is a normal float; the caller guarantees
// the first (kUp for wp; p - mu is 0 or far above it for real points).
// tests/test_torch_mups_design.py checks this sequence against IEEE
// division bit for bit.
__device__ __forceinline__ float div_by(float a, float b, float r) {
#ifdef PART_NO_DIV
  return __fmul_rn(a, r);
#else
  const float q0 = __fmul_rn(a, r);
  const float e = __fmaf_rn(-q0, b, a);
  return __fmaf_rn(e, r, q0);
#endif
}

// RN(1 / b), or 0 where |b| lies outside [lo, hi] or is not a number: the
// caller then divides with __fdiv_rn.  Taken once per divisor.
__device__ __forceinline__ float shared_reciprocal(float b, float lo, float hi) {
  const float m = fabsf(b);
  return (m >= lo && m <= hi) ? __frcp_rn(b) : 0.f;
}

// A float64 sum of float32 terms, as the plain version's _sum: one
// conversion and one double add a term, exact in practice (each add rounds
// at 2^-53 of the sum).
struct Sum {
  double total = 0.0;
#ifdef PART_NO_SUMS
  __device__ void add(float) {}
#else
  __device__ void add(float x) { total += static_cast<double>(x); }
#endif
};

// One thread's Gaussian, in registers.  A thread past K holds a Gaussian
// of weight coef 0: its wp is 0 and it adds nothing to the denominators.
struct Gaussian {
  float mu[3], sig[3];
  float rsig[3];  // RN(1 / sigma), or 0 where sigma takes __fdiv_rn
  float coef;     // the pdf coefficient times 2^64
  float w;
  bool fast;      // every rsig is nonzero
};

__device__ Gaussian load_gaussian(int k, int K, const float* __restrict__ w,
                                  const float* __restrict__ mu,
                                  const float* __restrict__ sigma) {
  Gaussian g;
  if (k < K) {
    g.fast = true;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      g.mu[d] = mu[3 * k + d];
      g.sig[d] = sigma[3 * k + d];
      g.rsig[d] = shared_reciprocal(g.sig[d], 0x1p-64f, 0x1p64f);
      g.fast = g.fast && g.rsig[d] != 0.f;
    }
    const float s0 = g.sig[0];
    g.coef = __fmul_rn(__fdiv_rn(1.0f, __fmul_rn(kTwoPiPow1p5,
                                                 __fmul_rn(__fmul_rn(s0, s0), s0))),
                       kUp);
    g.w = w[k];
  } else {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      g.mu[d] = 0.f;
      g.sig[d] = 1.f;
      g.rsig[d] = 1.f;
    }
    g.coef = 0.f;
    g.w = 1.f;
    g.fast = true;
  }
  return g;
}

// Shared memory of one block: the row's points as float4 (padded to a
// whole tile), the warps' partial denominators of two tiles (tile t writes
// buffer t % 2, so one barrier a tile suffices), each warp's copy of the
// tile's (denominator, reciprocal) pairs, [20, 32] per-warp sums, [20]
// norms, the block's ticket and the tickets' order (sort_units).
template <int T>
struct Smem {
  float4* pts;
  double* part;  // [2, warps, T]
  float2* den;   // [warps, T]
  float* red;    // [20, 32]
  float* norm;   // [20]
  unsigned* ticket;
  unsigned* order;  // [sort_length(units)]

  __device__ explicit Smem(unsigned char* base, int n_pad, int warps) {
    pts = reinterpret_cast<float4*>(base);
    part = reinterpret_cast<double*>(pts + n_pad);
    den = reinterpret_cast<float2*>(part + 2 * warps * T);
    red = reinterpret_cast<float*>(den + warps * T);
    norm = red + kChannels * kWarp;
    ticket = reinterpret_cast<unsigned*>(norm + kChannels);
    order = ticket + 1;
  }
  __host__ __device__ static size_t bytes(int n_pad, int warps, int sorted) {
    return 16 * static_cast<size_t>(n_pad) + 24 * static_cast<size_t>(warps) * T +
           4 * (kChannels * kWarp + kChannels) + 16 + 4 * static_cast<size_t>(sorted);
  }
};

// s and wp (times 2^64) of one tile's T points for this thread's Gaussian.
template <int T, bool kFast>
__device__ __forceinline__ void eval_tile(const float4* __restrict__ p,
                                          const Gaussian& g, float (&s)[T][3],
                                          float (&wp)[T]) {
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const float4 pt = p[j];
    const float pv[3] = {pt.x, pt.y, pt.z};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float a = __fsub_rn(pv[d], g.mu[d]);
      s[j][d] = kFast ? div_by(a, g.sig[d], g.rsig[d]) : __fdiv_rn(a, g.sig[d]);
    }
    const float d2 = __fadd_rn(
        __fadd_rn(__fmul_rn(s[j][0], s[j][0]), __fmul_rn(s[j][1], s[j][1])),
        __fmul_rn(s[j][2], s[j][2]));
#ifdef PART_NO_EXP
    const float e = __fmul_rn(-0.5f, d2);
#else
    const float e = expf(__fmul_rn(-0.5f, d2));
#endif
    wp[j] = __fmul_rn(__fmul_rn(g.coef, e), g.w);
  }
}

// The warp's sums of the tile's T denominators in double, reduced and
// scattered at once: at each of the first log2(T) butterfly steps a lane
// keeps half of its values and sends the other half to its partner; the
// last steps add whole values.  A lane shuffles T / 2 floats and
// T / 2 + 4 - log2(T) doubles (4 and 5 at T = 8) instead of 5 T doubles.
// Returns the warp's sum for point lane / (32 / T), the same in every lane
// that holds it.
template <int T>
__device__ __forceinline__ double warp_den(const float (&wp)[T], int lane) {
  static_assert(T >= 2 && T <= kWarp && (T & (T - 1)) == 0, "T: a power of 2, 2 to 32");
  // The first step shuffles the float32 values (one shuffle each instead
  // of two) and adds them in double: the same sums as converting first.
  double v[T / 2];
  {
    const bool upper = lane & (kWarp / 2);
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      const float send = upper ? wp[i] : wp[i + T / 2];
      const float keep = upper ? wp[i + T / 2] : wp[i];
      v[i] = static_cast<double>(keep) +
             static_cast<double>(__shfl_xor_sync(0xffffffffu, send, kWarp / 2));
    }
  }
  int off = kWarp / 4;
#pragma unroll
  for (int half = T / 4; half >= 1; half /= 2, off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const double send = upper ? v[i] : v[i + half];
      const double keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  double x = v[0];
#pragma unroll
  for (; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Every warp, from the warps' sums of the tile (all warps take the same
// steps, so all get the same values): lane l adds the sums of point l % T
// over warps l / T, l / T + 32 / T, ... in order, and the lanes of one
// point combine by butterfly.  Lane l ends with point l % T's float32
// denominator and its reciprocal (0 where the point takes __fdiv_rn);
// returns whether every real point of the tile has a reciprocal.
template <int T, int kMaxWarps>
__device__ __forceinline__ bool tile_denominators(const double* __restrict__ part, int lane,
                                                  int nwarps, int nt, float& d, float& r) {
  const int j = lane % T;
#ifdef PART_NO_DEN
  d = 1.f;
#else
  double den = 0.0;
#pragma unroll
  for (int i = lane / T; i < kMaxWarps; i += kWarp / T) {
    if (i < nwarps) den += part[i * T + j];
  }
#pragma unroll
  for (int off = T; off < kWarp; off *= 2) den += __shfl_xor_sync(0xffffffffu, den, off);
  d = static_cast<float>(den);
#endif
  r = shared_reciprocal(d, 1.f, 0x1p104f);  // den in [2^-64, 2^40]
  return __all_sync(0xffffffffu, r != 0.f || j >= nt);
}

// One Gaussian's 20 running statistics over the points so far.
struct Stats {
  float pi_max = -INFINITY;
  float mu_max[3] = {-INFINITY, -INFINITY, -INFINITY};
  float mu_min[3] = {INFINITY, INFINITY, INFINITY};
  float sg_max[3] = {-INFINITY, -INFINITY, -INFINITY};
  float sg_min[3] = {INFINITY, INFINITY, INFINITY};
  Sum pi_sum, mu_sum[3], sg_sum[3];
};

// q and the statistics of the tile's first nt points.  kFast: every
// denominator of the tile has its reciprocal (q by div_by); otherwise q by
// __fdiv_rn.  kFull: nt is T.
template <int T, bool kFast, bool kFull>
__device__ __forceinline__ void accumulate_tile(const float (&s)[T][3], const float (&wp)[T],
                                                const float2* __restrict__ den, int nt,
                                                float w, float rsw, Stats& st) {
#pragma unroll
  for (int j = 0; j < T; ++j) {
    if (kFull || j < nt) {
      const float2 dr = den[j];  // the same for the whole block
      const float q = kFast ? div_by(wp[j], dr.x, dr.y) : __fdiv_rn(wp[j], dr.x);
      const float dpi = __fmul_rn(__fsub_rn(q, w), rsw);
      st.pi_max = fmaxf(st.pi_max, dpi);
      st.pi_sum.add(dpi);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float a = __fmul_rn(q, s[j][d]);
        const float b = __fmul_rn(q, __fsub_rn(__fmul_rn(s[j][d], s[j][d]), 1.0f));
        st.mu_max[d] = fmaxf(st.mu_max[d], a);
        st.mu_min[d] = fminf(st.mu_min[d], a);
        st.mu_sum[d].add(a);
        st.sg_max[d] = fmaxf(st.sg_max[d], b);
        st.sg_min[d] = fminf(st.sg_min[d], b);
        st.sg_sum[d].add(b);
      }
    }
  }
}

// The [20, K] statistics of one row, computed by the whole block (every
// thread calls it; it synchronises).  Back-to-back calls need no barrier in
// between: every shared array is next written only after a barrier that
// follows all its reads.  Both kernels compute each row through this
// function, so their outputs are identical.
template <int T, int kMaxWarps>
__device__ void row_stats(const float* __restrict__ pts,  // [N, 3]
                          const int ne, const Gaussian& g, const Smem<T>& sh,
                          float* __restrict__ o,  // [20, K]
                          int N, int K) {
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const int n_real = max(min(ne, N - 1) + 1, 0);  // rows 0..n_eff are real
  const int n_pad = (n_real + T - 1) / T * T;
  const float eff = static_cast<float>(max(ne, 1));

  for (int n = tid; n < n_pad; n += blockDim.x) {
    sh.pts[n] = n < n_real ? make_float4(pts[3 * n], pts[3 * n + 1], pts[3 * n + 2], 0.f)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const float rsw = rsqrtf(g.w);
  Stats st;

  for (int n0 = 0; n0 < n_real; n0 += T) {
    float s[T][3], wp[T];
    if (g.fast) {
      eval_tile<T, true>(sh.pts + n0, g, s, wp);
    } else {
      eval_tile<T, false>(sh.pts + n0, g, s, wp);
    }

    // The tile's denominators: each warp's sums in double (warp_den), then
    // across warps, rounded to float32 as the plain version's _sum.  A warp
    // reads this tile's buffer of partial sums while a faster one may
    // already write the next tile's; it rewrites its copy of den only after
    // the next barrier, which its lanes pass after their reads.
    double* part = sh.part + (n0 / T % 2) * nwarps * T;
#ifndef PART_NO_DEN
    const double mine = warp_den<T>(wp, lane);
    if (lane % (kWarp / T) == 0) part[warp * T + lane / (kWarp / T)] = mine;
#endif
    __syncthreads();
    const int nt = min(T, n_real - n0);
    float d, r;
    const bool fast = tile_denominators<T, kMaxWarps>(part, lane, nwarps, nt, d, r);
    float2* den = sh.den + warp * T;  // this warp's copy
    if (lane < T) den[lane] = make_float2(d, r);
    __syncwarp();

    if (fast && nt == T) {
      accumulate_tile<T, true, true>(s, wp, den, nt, g.w, rsw, st);
    } else if (fast) {
      accumulate_tile<T, true, false>(s, wp, den, nt, g.w, rsw, st);
    } else {
      accumulate_tile<T, false, false>(s, wp, den, nt, g.w, rsw, st);
    }
  }

  if (n_real < N) {
    // Masked rows contribute exact zeros to every max/min (and nothing to
    // the sums).
    st.pi_max = fmaxf(st.pi_max, 0.f);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      st.mu_max[d] = fmaxf(st.mu_max[d], 0.f);
      st.mu_min[d] = fminf(st.mu_min[d], 0.f);
      st.sg_max[d] = fmaxf(st.sg_max[d], 0.f);
      st.sg_min[d] = fminf(st.sg_min[d], 0.f);
    }
  }
  float v[kChannels];
  const float rs2w = rsqrtf(__fmul_rn(2.0f, g.w));
  v[0] = st.pi_max;
  v[1] = static_cast<float>(st.pi_sum.total);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    v[2 + d] = __fmul_rn(st.mu_max[d], rsw);
    v[5 + d] = __fmul_rn(st.mu_min[d], rsw);
    v[8 + d] = __fmul_rn(static_cast<float>(st.mu_sum[d].total), rsw);
    v[11 + d] = __fmul_rn(st.sg_max[d], rs2w);
    v[14 + d] = __fmul_rn(st.sg_min[d], rs2w);
    v[17 + d] = __fmul_rn(static_cast<float>(st.sg_sum[d].total), rs2w);
  }
  const int k = tid;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    v[c] = k < K ? signed_sqrt(__fdiv_rn(v[c], eff)) : 0.f;
  }

  // L2 over the Gaussians, per channel: warp sums, then across warps.
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    float sq = __fmul_rn(v[c], v[c]);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      sq = __fadd_rn(sq, __shfl_down_sync(0xffffffffu, sq, off));
    }
    if (lane == 0) sh.red[c * kWarp + warp] = sq;
  }
  __syncthreads();
  if (tid < kChannels) {
    float total = 0.f;
    for (int i = 0; i < nwarps; ++i) total += sh.red[tid * kWarp + i];
    sh.norm[tid] = rsqrtf(fmaxf(total, 1e-12f));
  }
  __syncthreads();

  if (k < K) {
#pragma unroll
    for (int c = 0; c < kChannels; ++c) o[c * K + k] = __fmul_rn(v[c], sh.norm[c]);
  }
}

// Up to kMaxSorted units, the tickets hand them out longest first: a row's
// time grows with its real points, and a wave that ends on the long rows
// leaves SMs idle (PART_NO_SORT takes them in order, for timing).  Every
// block sorts the units' keys (work, index) itself, by a
// bitonic sort in shared memory, so all blocks agree on the order without
// waiting for each other.
constexpr int kMaxSorted = 4096;
constexpr int kMaxWork = (1 << 20) - 1;

__host__ __device__ inline int sort_length(int units) {
#ifdef PART_NO_SORT
  return 0;
#endif
  if (units > kMaxSorted) return 0;  // take the units in order
  int p = 1;
  while (p < units) p *= 2;
  return p;
}

__device__ void sort_units(unsigned* order, int p, int units, const int* __restrict__ n_eff,
                           int rows_per_unit, int N) {
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    unsigned key = 0xffffffffu;  // padding sorts last
    if (i < units) {
      int work = 0;
      for (int j = 0; j < rows_per_unit; ++j) {
        work += max(min(n_eff[i * rows_per_unit + j], N - 1) + 1, 0);
      }
      key = static_cast<unsigned>(kMaxWork - min(work, kMaxWork)) << 12 | i;
    }
    order[i] = key;
  }
  __syncthreads();
  for (int k = 2; k <= p; k *= 2) {
    for (int j = k / 2; j > 0; j /= 2) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned a = order[i], b = order[l];
          if ((a > b) == ((i & k) == 0)) {
            order[i] = b;
            order[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The persistent loop of both kernels: take a ticket, compute its unit's
// `rows_per_unit` consecutive rows, until the tickets run out.  tickets[0]
// is the next ticket, tickets[1] counts the blocks that are done; the last
// block to finish sets both back to 0 for the next launch on the stream
// (every block takes its last ticket before it counts itself done).
template <int T, int kMaxWarps>
__device__ void persistent_rows(const float* __restrict__ points,
                                const int* __restrict__ n_eff,
                                const float* __restrict__ w,
                                const float* __restrict__ mu,
                                const float* __restrict__ sigma,
                                float* __restrict__ out, unsigned* tickets,
                                int units, int rows_per_unit, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> sh(smem, (N + T - 1) / T * T, blockDim.x / kWarp);
  const Gaussian g = load_gaussian(threadIdx.x, K, w, mu, sigma);
  const int sorted = sort_length(units);
  if (sorted) sort_units(sh.order, sorted, units, n_eff, rows_per_unit, N);
  for (;;) {
    if (threadIdx.x == 0) *sh.ticket = atomicAdd(&tickets[0], 1u);
    __syncthreads();
    const unsigned t = *sh.ticket;
    if (t >= static_cast<unsigned>(units)) break;
    const unsigned unit = sorted ? sh.order[t] & 0xfffu : t;
    for (int j = 0; j < rows_per_unit; ++j) {
      const size_t r = static_cast<size_t>(unit) * rows_per_unit + j;
      row_stats<T, kMaxWarps>(points + r * N * 3, n_eff[r], g, sh, out + r * kChannels * K,
                              N, K);
    }
  }
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&tickets[1], 1u) == gridDim.x - 1) {
      atomicExch(&tickets[0], 0u);
      atomicExch(&tickets[1], 0u);
    }
  }
}

__host__ __device__ constexpr int tile_of(int max_threads) {
  return max_threads <= 512 ? kTile : kWideTile;
}

// One row per ticket.  kMaxThreads 512 up to 512 Gaussians, 1024 above.
template <int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
tdmfv_n_est_kernel(const float* __restrict__ points,  // [R, N, 3]
                   const int* __restrict__ n_eff,     // [R]
                   const float* __restrict__ w,       // [K]
                   const float* __restrict__ mu,      // [K, 3]
                   const float* __restrict__ sigma,   // [K, 3]
                   float* __restrict__ out,           // [R, 20, K]
                   unsigned* tickets,                 // [2], 0 between launches
                   int R, int N, int K) {
  persistent_rows<tile_of(kMaxThreads), kMaxThreads / kWarp>(points, n_eff, w, mu, sigma, out,
                                                              tickets, R, 1, N, K);
}

// One group of `block_b` consecutive rows per ticket, computed one after
// the other, as the TPU program's sequential `for j in range(block_b)`.
// Fewer, longer tickets: at R = 768 and block_b = 8 there are 96 groups
// for 132 SMs, so block_b > 1 trades balance for nothing on this card (the
// Gaussians' constants are loaded once per block in both kernels).
template <int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
tdmfv_n_est_blocked_kernel(const float* __restrict__ points,  // [R, N, 3]
                           const int* __restrict__ n_eff,     // [R]
                           const float* __restrict__ w,       // [K]
                           const float* __restrict__ mu,      // [K, 3]
                           const float* __restrict__ sigma,   // [K, 3]
                           float* __restrict__ out,           // [R, 20, K]
                           unsigned* tickets,                 // [2]
                           int R, int N, int K, int block_b) {
  persistent_rows<tile_of(kMaxThreads), kMaxThreads / kWarp>(
      points, n_eff, w, mu, sigma, out, tickets, R / block_b, block_b, N, K);
}

// Threads, shared memory and the persistent grid of one launch: as many
// blocks as fit on the card at once (the occupancy that ptxas's registers
// allow), but no more than there are tickets.
template <int kMaxThreads, typename Kernel>
cudaError_t launch_shape(Kernel kernel, int units, int N, int K, int* grid,
                         int* threads, size_t* smem) {
  constexpr int T = tile_of(kMaxThreads);
  *threads = (K + kWarp - 1) / kWarp * kWarp;
  *smem = Smem<T>::bytes((N + T - 1) / T * T, *threads / kWarp, sort_length(units));
  cudaError_t err = cudaSuccess;
  if (*smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(*smem));
    if (err != cudaSuccess) return err;
  }
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, *threads,
                                                           *smem)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = units < per_sm * sms ? units : per_sm * sms;
  return cudaSuccess;
}

template <int kMaxThreads>
int launch_rows(const void* points, const void* n_eff, const void* w, const void* mu,
                const void* sigma, void* out, void* tickets, int R, int N, int K,
                int block_b, cudaStream_t stream) {
  int grid, threads;
  size_t smem;
  const auto* p = static_cast<const float*>(points);
  const auto* ne = static_cast<const int*>(n_eff);
  const auto* wf = static_cast<const float*>(w);
  const auto* mf = static_cast<const float*>(mu);
  const auto* sf = static_cast<const float*>(sigma);
  auto* o = static_cast<float*>(out);
  auto* t = static_cast<unsigned*>(tickets);
  cudaError_t err;
  if (block_b == 0) {
    err = launch_shape<kMaxThreads>(tdmfv_n_est_kernel<kMaxThreads>, R, N, K, &grid,
                                    &threads, &smem);
    if (err != cudaSuccess) return err;
    tdmfv_n_est_kernel<kMaxThreads><<<grid, threads, smem, stream>>>(p, ne, wf, mf, sf, o,
                                                                     t, R, N, K);
  } else {
    err = launch_shape<kMaxThreads>(tdmfv_n_est_blocked_kernel<kMaxThreads>, R / block_b,
                                    N, K, &grid, &threads, &smem);
    if (err != cudaSuccess) return err;
    tdmfv_n_est_blocked_kernel<kMaxThreads><<<grid, threads, smem, stream>>>(
        p, ne, wf, mf, sf, o, t, R, N, K, block_b);
  }
  return static_cast<int>(cudaGetLastError());
}

// block_b 0 launches kernel 1, block_b > 0 the blocked kernel.
int launch(const void* points, const void* n_eff, const void* w, const void* mu,
           const void* sigma, void* out, void* tickets, int R, int N, int K, int block_b,
           void* stream) {
  if (N <= 0 || K <= 0 || K > 1024) return cudaErrorInvalidValue;
  if (R <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return K <= 512 ? launch_rows<512>(points, n_eff, w, mu, sigma, out, tickets, R, N, K,
                                     block_b, s)
                  : launch_rows<1024>(points, n_eff, w, mu, sigma, out, tickets, R, N, K,
                                      block_b, s);
}

}  // namespace

extern "C" {

// Launches the one-row-per-ticket kernel on `stream` over R rows.
// `tickets` is 2 unsigned ints that are 0 before the launch (the kernel
// leaves them 0); one launch at a time may use them.  Returns the CUDA
// error code of the launch (0 on success); allocates nothing and does not
// synchronise.
int tdmfv_n_est_launch(const void* points, const void* n_eff, const void* w,
                       const void* mu, const void* sigma, void* out, void* tickets,
                       int R, int N, int K, void* stream) {
  return launch(points, n_eff, w, mu, sigma, out, tickets, R, N, K, 0, stream);
}

// Launches the blocked kernel: R / block_b tickets of block_b rows each.
// R must be a multiple of block_b (cudaErrorInvalidValue otherwise).
int tdmfv_n_est_blocked_launch(const void* points, const void* n_eff, const void* w,
                               const void* mu, const void* sigma, void* out,
                               void* tickets, int R, int N, int K, int block_b,
                               void* stream) {
  if (block_b <= 0 || R % block_b != 0) return cudaErrorInvalidValue;
  return launch(points, n_eff, w, mu, sigma, out, tickets, R, N, K, block_b, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
