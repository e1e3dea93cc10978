// CTC forward-backward in log space for Hopper (sm_90a).
//
// Replaces the Pallas pair of stylish_tts_tpu/ops/ctc_pallas.py,
// ctc_alphas_betas_pallas, in the same structure: its two pl.pallas_call
// trellises (_alpha_kernel via :207, _beta_kernel via :237) become one
// kernel whose CTAs walk both at once, and the plain-JAX gradient glue
// _ctc_bwd (:295) becomes one parallel pass.
//
//   ctc_alpha_beta_fwd  grid (B, 2): CTA (b, 0) walks alpha forward over
//                       t = 0 .. len-1 while CTA (b, 1) walks beta
//                       backward over t = len-1 .. 0, so the whole
//                       forward-backward is one T-step chain on 2B SMs.
//                       With no gradient wanted, grid (B, 1): alpha only,
//                       nothing stored but ll.
//   ctc_grad_bwd        grid (T / 8, B), one warp per frame: reads
//                       the live alpha and beta rows, forms
//                       gamma = exp(alpha + beta - N_t), sums it into C
//                       class bins in shared memory and writes
//                       grad[b, t, :] = -g[b] * bins, zeros for t >= len.
//
// The spec is stylish_tts_torch/ops/ctc.py (ctc_nll, ctc_alphas_betas,
// ctc_grad_from_alphas_betas): NEG = -1e30 (never -inf), the skip
// s-2 -> s only where z_s != blank and z_s != z_{s-2} (for beta taken at
// the destination), t = 0 live only at states {0, 1} (1 only if L > 0),
// states >= 2L+1 dead, ll = LSE(alpha[len-1] at 2L and max(2L-1, 0)).
// beta[t] excludes the emission at t; its final row is log(number of final
// indices equal to s): 0 at {2L, 2L-1} and log 2 at s = 0 when L = 0, the
// exact derivative of ll (the Pallas final mask gives half of it there).
// Emissions are gathered from log_probs[b, t, z_s]; the (T, B, S) emission
// tensor of the Pallas glue is never built.
//
// What bounds the forward on this card: the chain of T dependent frames,
// each one barrier plus a three-term log-sum-exp per state, on one SM per
// CTA (two CTAs share an SM once 2B > 132). The design:
// - No double arithmetic on the chain. The running values reach
//   |alpha| ~ 5 T, beyond float32 (ulp 1e-4 at 2000), so each is a
//   float-float pair (hi, lo) in shared memory, 44 bits, all on the FP32
//   pipe; only the bounded part log(sum of e^{x - max}), in [0, log 3],
//   goes through the MUFU (ex2.approx / lg2.approx, about 2e-7 off). With
//   the running values in double, much of each frame went to converting
//   between double and float around the MUFU (a conversion to or from
//   double issues at a quarter of the FP64 rate).
// - Emissions prefetched: each thread's class ids are fixed, so it loads
//   its states' log_probs of step i + 4 into a register ring while it
//   works on step i (cp.async rows through shared memory cost more: the
//   wait and the gather sat on the chain).
// - One barrier per frame: the trellis row and the warps' partial row
//   maxima are double-buffered. Each thread owns K fixed states (K = 1, or
//   2 for S = 1025 > 1024 threads), its class ids and skip flags in
//   registers.
// - Storage for the gradient pass: 4 B per live state, a float32 residual
//   against a per-(b, t) offset. The offset of a step is the row maximum
//   two steps back (0 for the first two): each warp publishes its maximum
//   with one REDUX a step later, and each warp reads the 32 keys in one
//   shared-memory wavefront and one REDUX, so it costs no barrier. Only
//   t < len and s < 2L+1 are written.
//
// What bounds the gradient pass: bytes (alpha and beta at 4 B per live
// state-frame in, C floats per frame out). gamma is normalised per frame,
// as the plain ctc_grad_from_alphas_betas does: in exact arithmetic
// N_t = LSE_s(alpha + beta) equals ll for every t < len of a row that some
// alignment fits, but the rounding of the two chains' MUFU parts differs,
// and against ll it accumulates over T frames
// (scripts/ctc_gamma_error_sim.py: 4.9e-6 in gamma at T = 440 with 2-ulp
// errors, 2.1e-4 when they lean one way by an ulp); against N_t only what
// differs between the states of one frame remains (8.2e-7). So the
// offsets cancel and are not read here. A row that no alignment fits
// (too few frames for its labels and repeats: ll at NEG) gets a zero
// gradient, on all three sides (ctc_nll, the plain pass, this kernel).
// alpha + beta is summed exactly as a float-float pair. The blank bin is
// summed per warp with shuffles, label bins take a shared atomic each, so
// their order of summation varies from run to run.

#include <cuda_runtime.h>

namespace {

constexpr float kNegF = -1e30f;
constexpr float kLn2LoF = -1.9046543231e-09f;  // ln 2 - float(ln 2)
constexpr float kLog2eF = 1.4426950408889634f;
constexpr float kLn2F = 0.69314718055994530942f;
constexpr float kLowF = -3.0e38f;  // below every value, NEG included
constexpr int kAhead = 4;  // steps of emissions in flight in registers
constexpr int kGradWarps = 8;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Running trellis values are float-float pairs (hi, lo), value = hi + lo:
// a + b as such a pair, exactly.
__device__ __forceinline__ float2 two_sum(float a, float b) {
  const float s = a + b;
  const float bb = s - a;
  return make_float2(s, (a - (s - bb)) + (b - bb));
}

// log(e^a + e^b + e^c) + e: the largest hi as reference, the bounded rest
// log(sum of e^{(x.hi - m) + x.lo}), in [0, log 3] up to the lo parts,
// through the MUFU; the two additions exact (two_sum)
__device__ __forceinline__ float2 lse3_plus(float2 a, float2 b, float2 c,
                                            float e) {
  const float m = fmaxf(fmaxf(a.x, b.x), c.x);
  const float sum = ex2(((a.x - m) + a.y) * kLog2eF) +
                    ex2(((b.x - m) + b.y) * kLog2eF) +
                    ex2(((c.x - m) + c.y) * kLog2eF);
  const float2 fe = two_sum(lg2(sum) * kLn2F, e);
  const float2 v = two_sum(m, fe.x);
  return make_float2(v.x, v.y + fe.y);
}

__device__ __forceinline__ float2 add(float2 v, float e) {
  const float2 w = two_sum(v.x, e);
  return make_float2(w.x, w.y + v.y);
}

// a float as an int of the same order, so that one REDUX takes a warp's
// maximum; the map is its own inverse
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float from_order_key(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// One direction of the trellis for sequence blockIdx.x. Step i handles
// frame t = i (alpha) or t = len-1-i (beta). Row p = s + 2 of the padded
// shared rows holds state s; two NEG cells guard each end.
template <int K, bool kBeta>
__device__ void walk(const float* __restrict__ log_probs,
                     const int* __restrict__ labels,
                     const int* __restrict__ input_lengths,
                     const int* __restrict__ label_lengths, int T, int C,
                     int U, int blank, float* __restrict__ out,
                     double* __restrict__ offsets, double* __restrict__ ll) {
  extern __shared__ float4 smem[];
  const int S = 2 * U + 1;
  const int P = S + 4;
  float2* prev = reinterpret_cast<float2*>(smem);
  float2* cur = prev + P;
  int* wmax = reinterpret_cast<int*>(cur + P);  // [2][32] order keys
  const float2 neg = make_float2(kNegF, 0.f);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool store = out != nullptr;
  const int len = min(max(input_lengths[b], 1), T);
  const int L = min(max(label_lengths[b], 0), U);
  const int n_valid = 2 * L + 1;
  const int* lab = labels + static_cast<size_t>(b) * U;
  const float* lp_b = log_probs + static_cast<size_t>(b) * T * C;
  if (store) {
    out += static_cast<size_t>(b) * T * S;
    offsets += (static_cast<size_t>(b) * 2 + (kBeta ? 1 : 0)) * T;
  }

  // the states of this thread: class id (its emission column, clamped
  // when out of range, which makes the emission NEG) and skip flag
  int zc[K];
  bool live[K], zok[K], skip[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = tid + j * blockDim.x;
    live[j] = s < n_valid;
    const int z = !live[j] ? blank : ((s & 1) ? lab[s >> 1] : blank);
    zok[j] = z >= 0 && z < C;
    zc[j] = zok[j] ? z : 0;
    if (kBeta) {
      const int zd = s + 2 < n_valid ? ((s & 1) ? lab[(s + 2) >> 1] : blank)
                                     : blank;
      skip[j] = s + 2 < n_valid && zd != blank && zd != z;
    } else {
      const int zs = s >= 2 ? ((s & 1) ? lab[(s - 2) >> 1] : blank) : blank;
      skip[j] = s >= 2 && z != blank && z != zs;
    }
  }

  for (int i = tid; i < 2 * P; i += blockDim.x) prev[i] = neg;
  for (int i = tid; i < 64; i += blockDim.x) wmax[i] = order_key(kLowF);
  // step 0 writes cells that other threads filled above
  __syncthreads();

  // the emissions of this thread's states at step i, NEG past len
  auto emissions = [&](int i, float* e) {
    const bool in = i < len;
    const float* row = lp_b + static_cast<size_t>(in ? (kBeta ? len - 1 - i : i) : 0) * C;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      e[j] = (in && live[j] && zok[j]) ? __ldg(row + zc[j]) : kNegF;
    }
  };
  // those of steps 1 .. kAhead in flight before step 0
  float ahead[kAhead][K];
#pragma unroll
  for (int d = 0; d < kAhead; ++d) emissions(d + 1, ahead[d]);

  // step 0: alpha at t = 0, or beta's final row at t = len-1
  float tmax = kLowF;
  {
    const int t = kBeta ? len - 1 : 0;
    float e0[K];
    emissions(0, e0);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!live[j]) continue;
      const int s = tid + j * blockDim.x;
      float2 v, w;
      if (kBeta) {
        const int n_final = (s == 2 * L) + (s == max(2 * L - 1, 0));
        v = n_final == 0 ? neg
                         : (n_final == 2 ? make_float2(kLn2F, kLn2LoF)
                                         : make_float2(0.f, 0.f));
        w = add(v, e0[j]);
      } else {
        v = s <= 1 ? make_float2(e0[j], 0.f) : neg;  // s == 1 live only if L > 0
        w = v;
      }
      prev[s + 2] = w;
      if (store) out[static_cast<size_t>(t) * S + s] = v.x + v.y;
      tmax = fmaxf(tmax, v.x);
    }
    if (store && tid == 0) offsets[t] = 0.0;
  }
  __syncthreads();

  // step i >= 1 with the emissions e of its frame
  auto step = [&](int i, const float* e) {
    const int t = kBeta ? len - 1 - i : i;
    // publish the row maximum of step i-1 (one order key per warp); the
    // offset is the maximum of step i-2, one key per lane and a REDUX, so
    // that each warp reads the 32 keys in one shared-memory wavefront
    int wk = 0;
    if (store) {
      wk = wmax[((i - 2) & 1) * 32 + lane];
      const int mine = __reduce_max_sync(0xffffffffu, order_key(tmax));
      if (lane == 0) wmax[((i - 1) & 1) * 32 + warp] = mine;
    }
    float2 v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!live[j]) continue;
      const int p = tid + j * blockDim.x + 2;
      if (kBeta) {
        v[j] = lse3_plus(prev[p], prev[p + 1], skip[j] ? prev[p + 2] : neg, 0.f);
        cur[p] = add(v[j], e[j]);
      } else {
        v[j] = lse3_plus(prev[p], prev[p - 1], skip[j] ? prev[p - 2] : neg, e[j]);
        cur[p] = v[j];
      }
    }
    if (store) {
      const float o = i >= 2 ? from_order_key(__reduce_max_sync(0xffffffffu, wk))
                             : 0.f;
      tmax = kLowF;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (!live[j]) continue;
        // v - o: hi - o is exact where it matters (Sterbenz), then lo
        out[static_cast<size_t>(t) * S + tid + j * blockDim.x] = (v[j].x - o) + v[j].y;
        tmax = fmaxf(tmax, v[j].x);
      }
      if (tid == 0) offsets[t] = static_cast<double>(o);
    }
    __syncthreads();
    float2* tmp = prev;
    prev = cur;
    cur = tmp;
  };

  // whole groups of kAhead steps, unrolled so that the register ring of
  // emissions is indexed statically; then the last few steps
  int i0 = 1;
  for (; i0 + kAhead <= len; i0 += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      float e[K];
#pragma unroll
      for (int j = 0; j < K; ++j) e[j] = ahead[d][j];
      emissions(i0 + d + kAhead, ahead[d]);
      step(i0 + d, e);
    }
  }
#pragma unroll
  for (int d = 0; d < kAhead - 1; ++d) {
    if (i0 + d < len) step(i0 + d, ahead[d]);
  }

  if (!kBeta && tid == 0) {
    const float2 b2 = prev[2 * L + 2];
    const float2 l2 = prev[max(2 * L - 1, 0) + 2];
    const double fb = static_cast<double>(b2.x) + static_cast<double>(b2.y);
    const double fl = static_cast<double>(l2.x) + static_cast<double>(l2.y);
    const double m = fmax(fb, fl);
    ll[b] = m + log(exp(fb - m) + exp(fl - m) + 1e-30);
  }
}

template <int K>
__global__ void ctc_alpha_beta_kernel(const float* __restrict__ log_probs,
                                      const int* __restrict__ labels,
                                      const int* __restrict__ input_lengths,
                                      const int* __restrict__ label_lengths,
                                      int T, int C, int U, int blank,
                                      float* __restrict__ alpha,
                                      float* __restrict__ beta,
                                      double* __restrict__ offsets,
                                      double* __restrict__ ll) {
  if (blockIdx.y == 0) {
    walk<K, false>(log_probs, labels, input_lengths, label_lengths, T, C, U,
                   blank, alpha, offsets, ll);
  } else {
    walk<K, true>(log_probs, labels, input_lengths, label_lengths, T, C, U,
                  blank, beta, offsets, ll);
  }
}

__global__ void ctc_grad_kernel(const float* __restrict__ alpha,
                                const float* __restrict__ beta,
                                const int* __restrict__ labels,
                                const int* __restrict__ input_lengths,
                                const int* __restrict__ label_lengths,
                                const double* __restrict__ ll,
                                const float* __restrict__ g, int T, int C,
                                int U, int blank, float* __restrict__ grad) {
  extern __shared__ float bins[];  // [kGradWarps][C], then the labels
  int* lab = reinterpret_cast<int*>(bins + kGradWarps * C);
  const int S = 2 * U + 1;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = min(max(input_lengths[b], 1), T);
  const int L = min(max(label_lengths[b], 0), U);
  const int n_valid = 2 * L + 1;
  const float gb = -g[b];
  float* row = bins + warp * C;

  for (int u = threadIdx.x; u < L; u += blockDim.x) {
    lab[u] = labels[static_cast<size_t>(b) * U + u];
  }
  for (int c = lane; c < C; c += 32) row[c] = 0.f;
  __syncthreads();

  // one frame per warp
  const int t = blockIdx.x * kGradWarps + warp;
  if (t >= T) return;
  float* grad_t = grad + (static_cast<size_t>(b) * T + t) * C;
  // no alignment fits the row (ll at NEG): no gradient, as in the spec
  if (t >= len || ll[b] <= 0.5 * kNegF) {
    for (int c = lane; c < C; c += 32) grad_t[c] = 0.f;
    return;
  }
  const float* a_t = alpha + (static_cast<size_t>(b) * T + t) * S;
  const float* b_t = beta + (static_cast<size_t>(b) * T + t) * S;

  // N_t = LSE_s(alpha + beta), alpha + beta as an exact float-float pair:
  // the frame's maximum m, then the sum; the loads of each pass are
  // independent, and the later passes read L1
  float m = kLowF;
#pragma unroll 4
  for (int s = lane; s < n_valid; s += 32) m = fmaxf(m, a_t[s] + b_t[s]);
  m = from_order_key(__reduce_max_sync(0xffffffffu, order_key(m)));
  float sum = 0.f;
#pragma unroll 4
  for (int s = lane; s < n_valid; s += 32) {
    const float2 x = two_sum(a_t[s], b_t[s]);
    sum += ex2(((x.x - m) + x.y) * kLog2eF);
  }
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  const float f = lg2(sum) * kLn2F;  // N_t - m, in [0, log S]

  float blank_sum = 0.f;
#pragma unroll 4
  for (int s = lane; s < n_valid; s += 32) {
    const float2 x = two_sum(a_t[s], b_t[s]);
    const float gamma = ex2((((x.x - m) + x.y) - f) * kLog2eF);
    if (s & 1) {
      const int z = lab[s >> 1];
      if (z >= 0 && z < C) atomicAdd(&row[z], gamma);
    } else {
      blank_sum += gamma;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    blank_sum += __shfl_xor_sync(0xffffffffu, blank_sum, off);
  }
  if (lane == 0) atomicAdd(&row[blank], blank_sum);
  __syncwarp();
  for (int c = lane; c < C; c += 32) grad_t[c] = gb * row[c];
}

template <int K>
int launch_alpha_beta(const float* log_probs, const int* labels,
                      const int* input_lengths, const int* label_lengths,
                      int B, int T, int C, int U, int blank, int directions,
                      float* alpha, float* beta, double* offsets, double* ll,
                      cudaStream_t stream) {
  const int S = 2 * U + 1;
  const int threads = ((S + K - 1) / K + 31) / 32 * 32;
  const size_t smem = 2 * static_cast<size_t>(S + 4) * sizeof(float2) +
                      64 * sizeof(int);
  ctc_alpha_beta_kernel<K><<<dim3(B, directions), threads, smem, stream>>>(
      log_probs, labels, input_lengths, label_lengths, T, C, U, blank, alpha,
      beta, offsets, ll);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel A. alpha, beta: (B, T, 2U+1) float32 residuals, offsets (B, 2, T)
// double (alpha's, then beta's), ll (B,) double. directions 1 runs alpha
// only and, with alpha, beta and offsets null, stores nothing but ll.
// Each thread owns one state, or two where S > 1024 threads (blockDim =
// ceil(S / K) rounded up to a warp). Returns cudaGetLastError() after the
// launch.
int ctc_alpha_beta_fwd(const float* log_probs, const int* labels,
                       const int* input_lengths, const int* label_lengths,
                       int B, int T, int C, int U, int blank, int directions,
                       float* alpha, float* beta, double* offsets, double* ll,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (2 * U + 1 <= 1024) {
    return launch_alpha_beta<1>(log_probs, labels, input_lengths,
                                label_lengths, B, T, C, U, blank, directions,
                                alpha, beta, offsets, ll, st);
  }
  return launch_alpha_beta<2>(log_probs, labels, input_lengths, label_lengths,
                              B, T, C, U, blank, directions, alpha, beta,
                              offsets, ll, st);
}

// Kernel B. grad (B, T, C) = -g[b] * sum of gamma into the classes, zero
// for the rows whose ll (kernel A's) is at NEG. Returns cudaGetLastError()
// after the launch.
int ctc_grad_bwd(const float* alpha, const float* beta, const int* labels,
                 const int* input_lengths, const int* label_lengths,
                 const double* ll, const float* g, int B, int T, int C, int U,
                 int blank, float* grad, void* stream) {
  const dim3 grid((T + kGradWarps - 1) / kGradWarps, B);
  const size_t smem = (static_cast<size_t>(kGradWarps) * C + U) * sizeof(float);
  ctc_grad_kernel<<<grid, kGradWarps * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      alpha, beta, labels, input_lengths, label_lengths, ll, g, T, C, U, blank,
      grad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
