// CTC forward-backward in log space for Hopper (sm_90a).
//
// Replaces the Pallas pair of stylish_tts_tpu/ops/ctc_pallas.py,
// ctc_alphas_betas_pallas: _alpha_kernel (the forward trellis) and
// _beta_kernel (the reverse trellis), plus the plain-JAX gradient glue
// _ctc_bwd (gamma = exp(alpha + beta - ll), scattered to classes).
//
//   ctc_alpha_fwd      one CTA per sequence walks t = 0 .. len-1 and
//                      writes alpha (B, T, S) and ll (B,).
//   ctc_beta_grad_bwd  one CTA per sequence walks t = len-1 .. 0 with the
//                      beta row in shared memory, forms gamma and sums it
//                      into a shared row of C class bins; it writes
//                      grad[b, t, :] = -g[b] * row, zeros for t >= len.
//                      beta never goes to device memory.
//
// The spec is stylish_tts_torch/ops/ctc.py: NEG = -1e30 (never -inf),
// +1e-30 inside every log-sum-exp, the skip s-2 -> s only where
// z_s != blank and z_s != z_{s-2}, t = 0 live only at states {0, 1}
// (state 1 only if U > 0), states >= 2U+1 dead, alpha frozen for
// t >= len (so the loop simply stops at len), ll = LSE(alpha[len-1] at
// 2U and max(2U-1, 0)). Emissions are gathered straight from
// log_probs[b, t, ext[s]]; the (T, B, S) emission tensor of the Pallas
// glue is never built. The final beta row is log(number of final states
// equal to s): 0 at {2U, 2U-1}, and log 2 at s = 0 when U = 0, where both
// final indices are 0 -- the exact derivative of ll (the Pallas VJP gives
// half of it there).
//
// Precision: log_probs come in and the gradient goes out as float32, but
// the trellis runs in double. alpha reaches |alpha| ~ 5 * T (about 2000 at
// T = 400), where a float32 ulp is 1e-4, and gamma = exp(alpha + beta - ll)
// inherits that error: the plain float32 version is 1.5e-4 off its own
// float64 result in the gradient at T = 400. In double the kernel agrees
// with the plain version run in float64 to float32 rounding.
//
// What bounds it on this card: T dependent steps per sequence, each
// paying one __syncthreads plus a few shared-memory round trips and a
// chain of double exp/log, with B CTAs (B <= 128 here, the card has 132
// SMs). The bytes (log_probs and grad at 4 B, alpha at 8 B per state
// here, 4 B in a float32 design) take tens of microseconds at 3.35 TB/s,
// so the kernels are latency-bound. The design keeps every step to one
// barrier: the alpha row, and in the backward the term row
// (beta + emission) and the class row, are double-buffered in shared
// memory. Each thread owns ceil(S / blockDim) states, since S = 2U+1
// reaches 1025 (> 1024 threads). Blank occurs U+1 times per row, so the
// blank bin is summed per warp with shuffles before one shared atomic;
// label bins take a shared atomic each, so their order of summation
// varies from run to run.

#include <cuda_runtime.h>

namespace {

constexpr double kNeg = -1e30;
constexpr double kLog2 = 0.69314718055994530942;

__device__ __forceinline__ double lse3(double a, double b, double c) {
  const double m = fmax(fmax(a, b), c);
  return m + log(exp(a - m) + exp(b - m) + exp(c - m) + 1e-30);
}

__device__ __forceinline__ void load_ext(int* ext, const int* labels_b, int S,
                                         int blank) {
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    ext[s] = (s & 1) ? labels_b[s >> 1] : blank;
  }
}

__global__ void ctc_alpha_kernel(const float* __restrict__ log_probs,
                                 const int* __restrict__ labels,
                                 const int* __restrict__ input_lengths,
                                 const int* __restrict__ label_lengths,
                                 int T, int C, int U, int blank,
                                 double* __restrict__ alpha,
                                 double* __restrict__ ll) {
  extern __shared__ double smem[];
  const int S = 2 * U + 1;
  double* buf0 = smem;
  double* buf1 = smem + S;
  int* ext = reinterpret_cast<int*>(smem + 2 * S);

  const int b = blockIdx.x;
  const int len = min(max(input_lengths[b], 1), T);
  const int L = min(max(label_lengths[b], 0), U);
  const int n_valid = 2 * L + 1;
  const float* lp_b = log_probs + static_cast<size_t>(b) * T * C;
  double* alpha_b = alpha + static_cast<size_t>(b) * T * S;

  load_ext(ext, labels + static_cast<size_t>(b) * U, S, blank);
  __syncthreads();

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int z = ext[s];
    const bool live = (s == 0) || (s == 1 && L > 0);
    const double v = (live && z >= 0 && z < C) ? lp_b[z] : kNeg;
    buf0[s] = v;
    alpha_b[s] = v;
  }
  __syncthreads();

  double* prev = buf0;
  double* cur = buf1;
  for (int t = 1; t < len; ++t) {
    const float* lp_t = lp_b + static_cast<size_t>(t) * C;
    double* alpha_t = alpha_b + static_cast<size_t>(t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      double v = kNeg;
      const int z = ext[s];
      if (s < n_valid && z >= 0 && z < C) {
        const double stay = prev[s];
        const double step1 = s >= 1 ? prev[s - 1] : kNeg;
        const bool skip = s >= 2 && z != blank && z != ext[s - 2];
        const double step2 = skip ? prev[s - 2] : kNeg;
        v = lse3(stay, step1, step2) + lp_t[z];
      }
      cur[s] = v;
      alpha_t[s] = v;
    }
    __syncthreads();
    double* tmp = prev;
    prev = cur;
    cur = tmp;
  }

  if (threadIdx.x == 0) {
    const double fb = prev[2 * L];
    const double fl = prev[max(2 * L - 1, 0)];
    const double m = fmax(fb, fl);
    ll[b] = m + log(exp(fb - m) + exp(fl - m) + 1e-30);
  }
}

__global__ void ctc_beta_grad_kernel(const float* __restrict__ log_probs,
                                     const int* __restrict__ labels,
                                     const int* __restrict__ input_lengths,
                                     const int* __restrict__ label_lengths,
                                     const double* __restrict__ alpha,
                                     const double* __restrict__ ll,
                                     const float* __restrict__ g,
                                     int T, int C, int U, int blank,
                                     float* __restrict__ grad) {
  extern __shared__ double smem[];
  const int S = 2 * U + 1;
  double* term0 = smem;  // beta[t] + emission[t], double-buffered by t & 1
  double* term1 = smem + S;
  double* row0 = smem + 2 * S;  // class bins, double-buffered by t & 1
  double* row1 = row0 + C;
  int* ext = reinterpret_cast<int*>(row1 + C);

  const int b = blockIdx.x;
  const int len = min(max(input_lengths[b], 1), T);
  const int L = min(max(label_lengths[b], 0), U);
  const int n_valid = 2 * L + 1;
  const int last_blank = 2 * L;
  const int last_label = max(2 * L - 1, 0);
  const double ll_b = ll[b];
  const double g_b = g[b];
  const bool blank_ok = blank >= 0 && blank < C;
  const float* lp_b = log_probs + static_cast<size_t>(b) * T * C;
  const double* alpha_b = alpha + static_cast<size_t>(b) * T * S;
  float* grad_b = grad + static_cast<size_t>(b) * T * C;

  load_ext(ext, labels + static_cast<size_t>(b) * U, S, blank);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    row0[c] = 0.0;
    row1[c] = 0.0;
  }
  const size_t tail = static_cast<size_t>(T - len) * C;
  for (size_t i = threadIdx.x; i < tail; i += blockDim.x) {
    grad_b[static_cast<size_t>(len) * C + i] = 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int t = len - 1; t >= 0; --t) {
    const double* term_next = (t & 1) ? term0 : term1;  // written at t + 1
    double* term_cur = (t & 1) ? term1 : term0;
    double* row = (t & 1) ? row1 : row0;
    const float* lp_t = lp_b + static_cast<size_t>(t) * C;
    const double* alpha_t = alpha_b + static_cast<size_t>(t) * S;

    double blank_sum = 0.0;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const int z = ext[s];
      double term = kNeg;
      if (s < n_valid && z >= 0 && z < C) {
        double beta;
        if (t == len - 1) {
          const int n_final = (s == last_blank) + (s == last_label);
          beta = n_final == 0 ? kNeg : (n_final == 2 ? kLog2 : 0.0);
        } else {
          const double stay = term_next[s];
          const double step1 = s + 1 < S ? term_next[s + 1] : kNeg;
          const bool skip = s + 2 < S && ext[s + 2] != blank &&
                            ext[s + 2] != z;
          const double step2 = skip ? term_next[s + 2] : kNeg;
          beta = lse3(stay, step1, step2);
        }
        const double gamma = exp(alpha_t[s] + beta - ll_b);
        if (z == blank) {
          blank_sum += gamma;
        } else {
          atomicAdd(&row[z], gamma);
        }
        term = beta + lp_t[z];
      }
      term_cur[s] = term;
    }
    for (int off = 16; off > 0; off >>= 1) {
      blank_sum += __shfl_xor_sync(0xffffffffu, blank_sum, off);
    }
    if (lane == 0 && blank_ok && blank_sum != 0.0) {
      atomicAdd(&row[blank], blank_sum);
    }
    __syncthreads();
    float* grad_t = grad_b + static_cast<size_t>(t) * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      grad_t[c] = static_cast<float>(-g_b * row[c]);
      row[c] = 0.0;
    }
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of each launch: under 48 KB for S <= 1025 and
// C <= 1024, the limits ctc_cuda.py enforces.
int ctc_alpha_smem_bytes(int U) { return 2 * (2 * U + 1) * 8 + (2 * U + 1) * 4; }
int ctc_beta_grad_smem_bytes(int U, int C) {
  return (2 * (2 * U + 1) + 2 * C) * 8 + (2 * U + 1) * 4;
}

// Both return cudaGetLastError() after the launch (0 = launched).
int ctc_alpha_fwd(const float* log_probs, const int* labels,
                  const int* input_lengths, const int* label_lengths, int B,
                  int T, int C, int U, int blank, double* alpha, double* ll,
                  int threads, void* stream) {
  ctc_alpha_kernel<<<B, threads, ctc_alpha_smem_bytes(U),
                     static_cast<cudaStream_t>(stream)>>>(
      log_probs, labels, input_lengths, label_lengths, T, C, U, blank, alpha,
      ll);
  return static_cast<int>(cudaGetLastError());
}

int ctc_beta_grad_bwd(const float* log_probs, const int* labels,
                      const int* input_lengths, const int* label_lengths,
                      const double* alpha, const double* ll, const float* g,
                      int B, int T, int C, int U, int blank, float* grad,
                      int threads, void* stream) {
  ctc_beta_grad_kernel<<<B, threads, ctc_beta_grad_smem_bytes(U, C),
                         static_cast<cudaStream_t>(stream)>>>(
      log_probs, labels, input_lengths, label_lengths, alpha, ll, g, T, C, U,
      blank, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
