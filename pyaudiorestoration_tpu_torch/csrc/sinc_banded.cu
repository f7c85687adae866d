// Banded windowed-sinc varispeed resampler for Hopper (sm_90a): kernels K1
// and K2, two entries onto one device code.
//
// K1 (sinc_banded_f32) replaces pyaudiorestoration_tpu/kernels/sinc_pallas.py:
// sinc_banded_pallas_dma_segments (its body _kernel_dma and _shift_mac): it
// takes the signal and the per-segment integer anchors and loads each row's
// window itself.  K2 (sinc_banded_gathered_f32) replaces sinc_pallas.py:
// sinc_banded_pallas (its body _kernel and _shift_mac): it takes the
// (T, max_n + 2U) window buffer that the caller gathered, row i starting at
// base_int_i - U and zero outside the signal.  Both take the (bs, rel,
// in_seg) grids of segment_grids and write the (T, max_n) padded output.
//
//   out[i,k] = sum_j win_i[round(rel_ik) + U + j]
//                    * sinc(fc (j - shift_ik)) * fc * hann_{2nt+1}[j + nt]
//   fc = min(bs_ik, 1), shift = rel - round(rel), j in [-nt, nt)
//   win_i[p] = sig[base_int_i - U + p] (zero outside the signal)
//
// Zero where k >= n_i (in_seg == 0).  A tap counts only where its window
// position p = round(rel) + U + j lies in [k, k + 2U), U = nt + drift: that
// is the window the shift-MAC of the JAX tiers sees, so the two agree even
// where |round(rel) - k| <= drift fails.  The entries differ only in how the
// window reaches shared memory; the tap loop below is the single copy both
// run.
//
// What bounds them on the card: per output sample 2*nt sinc evaluations
// (sinpif, a divide) and multiply-adds, against ~4 bytes of HBM read (the
// window, reused 2*nt times from shared memory) and 4 bytes written.  At
// the main path's shapes (nt 50) that is ~100 x ~40 instructions per 8 bytes,
// far above the ~20 FLOP/byte where an H100 stops being HBM-bound: both are
// bound by FP32 issue and the special-function unit.  K2 adds one HBM read
// of the gathered buffer, (max_n + 2U) / max_n times the output's bytes
// (~1.2x at max_n 563, U 66), which torch's gather wrote just before: the
// gather's write and K2's read are its cost over K1, since K1 reads the
// signal in place.  Fusing the gather away is later work.
//
// What the simple design does about it: one CTA per segment row stages the
// row's window (max_n + 2U samples) and the hann taper (2*nt weights) in
// shared memory once, so HBM is read once per sample and the taper's cos
// leaves the tap loop; each thread walks its lanes and sums the taps of the
// valid range directly, with no per-tap predicate.  The TPU-only parts are
// not carried over: the (n/128, 128) view with 1024-aligned starts and its
// 10-stage roll network, the tile of 8 or 16 rows per grid step and its
// BlockSpec blocks, the pltpu.roll shift passes and the compile-time pass
// skipping.  Removing the per-tap sinpif (rotation recurrences as in
// _shift_mac) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kPi = 3.14159265358979323846f;  // float32(np.pi), as JAX rounds it

// Where a row's window comes from.  kSignal (K1): the flattened signal and
// the row's integer anchor, zero outside [0, n_src).  kGathered (K2): row
// ``row`` of the caller's (T, L) buffer, already zero outside the signal.
enum class Window { kSignal, kGathered };

template <Window kWindow>
__global__ void __launch_bounds__(kThreads)
sinc_banded_kernel(const float* __restrict__ src, long long n_src,
                   const int* __restrict__ base_int,
                   const float* __restrict__ bs,
                   const float* __restrict__ rel,
                   const unsigned char* __restrict__ in_seg,
                   float* __restrict__ out, int max_n, int nt, int drift) {
  extern __shared__ float smem[];
  const int U = nt + drift;
  const int L = max_n + 2 * U;
  float* win = smem;       // window: sig[base_int - U + p], p in [0, L)
  float* hann = smem + L;  // taper: hann_{2nt+1}[t], t in [0, 2nt)

  const long long row = blockIdx.x;
  if constexpr (kWindow == Window::kSignal) {
    const long long start = static_cast<long long>(base_int[row]) - U;
    for (int p = threadIdx.x; p < L; p += blockDim.x) {
      const long long s = start + p;
      win[p] = (s >= 0 && s < n_src) ? src[s] : 0.0f;
    }
  } else {
    const float* buf = src + row * L;
    for (int p = threadIdx.x; p < L; p += blockDim.x) win[p] = buf[p];
  }
  for (int t = threadIdx.x; t < 2 * nt; t += blockDim.x) {
    hann[t] = 0.5f - 0.5f * cosf(kPi * static_cast<float>(t) / static_cast<float>(nt));
  }
  __syncthreads();

  const long long base = row * max_n;
  for (int k = threadIdx.x; k < max_n; k += blockDim.x) {
    float acc = 0.0f;
    if (in_seg[base + k]) {
      const float r = rel[base + k];
      const float anchor = rintf(r);  // half to even, as jnp.round
      const float shift = r - anchor;
      const float fc = fminf(bs[base + k], 1.0f);
      const int a = static_cast<int>(anchor);
      const int m = a - k;
      // p = a + U + j in [k, k + 2U)  <=>  j in [-U - m, U - m)
      const int j_lo = max(-nt, -U - m);
      const int j_hi = min(nt, U - m);
      for (int j = j_lo; j < j_hi; ++j) {
        const float x = (static_cast<float>(j) - shift) * fc;
        const float s = (x == 0.0f) ? 1.0f : sinpif(x) / (kPi * x);
        acc += win[a + U + j] * (s * fc * hann[j + nt]);
      }
    }
    out[base + k] = acc;
  }
}

template <Window kWindow>
int launch(const float* src, long long n_src, const int* base_int,
           const float* bs, const float* rel, const unsigned char* in_seg,
           float* out, int T, int max_n, int nt, int drift, void* stream) {
  const int U = nt + drift;
  const size_t smem = static_cast<size_t>(max_n + 2 * U + 2 * nt) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sinc_banded_kernel<kWindow>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sinc_banded_kernel<kWindow><<<T, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      src, n_src, base_int, bs, rel, in_seg, out, max_n, nt, drift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1.  Launch on ``stream``; returns cudaGetLastError() (0 on success).
extern "C" int sinc_banded_f32(const float* sig, long long n_sig,
                               const int* base_int, const float* bs,
                               const float* rel, const unsigned char* in_seg,
                               float* out, int T, int max_n, int nt, int drift,
                               void* stream) {
  return launch<Window::kSignal>(sig, n_sig, base_int, bs, rel, in_seg, out,
                                 T, max_n, nt, drift, stream);
}

// K2: ``buf`` is (T, max_n + 2 (nt + drift)), row-major.  Launch on
// ``stream``; returns cudaGetLastError() (0 on success).
extern "C" int sinc_banded_gathered_f32(const float* buf, const float* bs,
                                        const float* rel,
                                        const unsigned char* in_seg, float* out,
                                        int T, int max_n, int nt, int drift,
                                        void* stream) {
  return launch<Window::kGathered>(buf, 0, nullptr, bs, rel, in_seg, out, T,
                                   max_n, nt, drift, stream);
}
