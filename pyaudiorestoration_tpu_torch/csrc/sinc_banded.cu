// Banded windowed-sinc varispeed resampler for Hopper (sm_90a): kernels K1
// and K2, four entries onto one device code.
//
// K1 replaces pyaudiorestoration_tpu/kernels/sinc_pallas.py:
// sinc_banded_pallas_dma_segments (its body _kernel_dma and _shift_mac): it
// takes the signal and the per-segment integer anchors and loads each row's
// window itself.  K2 replaces sinc_pallas.py:sinc_banded_pallas (its body
// _kernel and _shift_mac): it takes the (T, max_n + 2U) window buffer that
// the caller gathered, row i starting at base_int_i - U and zero outside the
// signal.  Each has two entries:
//   *_plan_f32  takes each row's plan (s_lo, s_hi, n, base_frac) and builds
//               the row's grids in shared memory (the main path);
//   *_f32       takes the (T, max_n) bs, rel and in_seg grids (K1's is the
//               banded branch of sinc_resample, with host-planned rel).
// All write the (T, max_n) padded output:
//
//   out[i,k] = sum_j win_i[round(rel_ik) + U + j]
//                    * sinc(fc (j - shift_ik)) * fc * hann_{2nt+1}[j + nt]
//   fc = min(bs_ik, 1), shift = rel - round(rel), j in [-nt, nt)
//   win_i[p] = sig[base_int_i - U + p] (zero outside the signal)
//
// Zero where k >= n_i (in_seg == 0).  A tap counts only where its window
// position p = round(rel) + U + j lies in [k, k + 2U), U = nt + drift: the
// window the shift-MAC of the JAX tiers sees, so the two agree even where
// |round(rel) - k| <= drift fails.
//
// The plan entries' grids are those of segment_grids
// (pipelines/respeeder_device.py) bit for bit: bs = s_lo + (k / max(n-1, 1))
// * (s_hi - s_lo) with three roundings and inv = 1/bs as IEEE operations
// (written with __fdiv_rn / __fmul_rn / __fadd_rn / __fsub_rn, so nvcc
// contracts nothing into an FMA; never build this file with fast math), and
// rel = cumsum(inv) + base_frac in fixed_order_cumsum's order: sequential
// inside 16-element blocks, the block totals scanned the same way level by
// level, each exclusive carry added back.  One ulp of rel moves an output
// by ~2e-4 on noise, so this order is part of the result.
//
// What bounds them on the card.  At respeed --fast's shape (22,500 rows x
// max_n 519, nt 50) the work is 11.52 M outputs x 2 nt = 1.152 G taps.  A
// tap in the cheapest form (sine by angle addition, the denominator, a
// reciprocal with one Newton step, the quotient and taper, the MAC) is ~12
// FLOP: 13.8 GFLOP, 0.21 ms at the 67 TFLOP/s FP32 peak.  HBM moves ~93 MB
// through the plan entries (the signal, 16 bytes of plan a row, the output;
// the window is read once and reused 2 nt times from shared memory): 0.03 ms
// at 3.35 TB/s.  So they are bound by FP32 issue; one special-function op
// (MUFU, 16 a clock per SM) a tap would itself cost 0.28 ms.
//
// What the design does about it.
// - No per-tap sinpif and no divide (the previous design spent ~40
//   instructions a tap on them).  As in _shift_mac, each lane seeds
//   sin/cos(pi x) exactly once, at its centre tap j = 0 (one sincospif), and
//   one sincospif(fc) gives its step.  The taps j = 1 .. nt-1 and
//   j = -1 .. -(nt-1) (hann is 0 at j = -nt) go in blocks of kJ = 7 from an
//   anchor that rotates once a block; the sine of tap i of a block is
//   sa cos(i pi fc) + ca sin(i pi fc), so a block sums window * taper / e
//   against those two per-lane constants (two FMAs a tap) and the anchor
//   enters once.  The anchor chain of a side is (nt-1)/7 rotations, so its
//   drift stays ~1e-7 with no reseed.  A two-term Chebyshev recurrence is
//   not used: its error grows ~linearly where fc is near 1 (_shift_mac's
//   docstring).
// - fc cancels from the quotient: sinc(x) fc = sin(pi x) / (pi (j - shift)).
//   The denominator j - shift is evaluated afresh for every tap (no drift)
//   and is at least 0.5 from zero for j != 0, so a sine error is never
//   amplified, whatever fc: the Taylor series that _shift_mac needs for
//   |x| < 0.25 is not needed.  The centre tap j = 0, the only one that can
//   sit at x = 0, takes the exact seed.
// - The 7 reciprocals of a block come from one rcp.approx.ftz.f32 of their
//   product plus one Newton step and the prefix products: one MUFU op a
//   block.  hann / pi is a table in shared memory, in blocks of 7 taps that
//   every lane reads at the same address as two float4 (a broadcast).
// - Where fc = 1 (every lane whose speed is at or above 1, about half of a
//   wow take), sin(pi (j - shift)) = (-1)^j sin(-pi shift): that path does
//   no sine work at all.
// - Per tap, from cuobjdump -sass (profile_stages.py --sass): ~11
//   instructions on the general path and ~8.4 on the fc = 1 path.
// - Launch shape: persistent CTAs of at most kMaxThreads threads (one lane
//   a thread, a row in one or two passes; 4 CTAs an SM at 56 registers),
//   each walking rows with a stride of the grid.  While a row's lanes run,
//   the next row's window streams into the other half of a double buffer
//   with cp.async, so its load latency overlaps the tap loop.  A lane whose
//   anchor breaks the drift contract takes a predicated copy of the loop;
//   inside the contract no tap is predicated.
// - The plan entries build the grids in shared memory (one launch over all
//   rows; the torch grids took ~55 launches per 4,096-row chunk): the
//   lerp and 1/bs by every thread, the 16-element local scans by a thread
//   each, the scan of their totals by one warp, and each lane adds its
//   block's carry as it reads rel.
// The TPU-only parts are not carried over: the (n/128, 128) view with
// 1024-aligned starts and its roll network, the tiles of 8 or 16 rows and
// their BlockSpecs, the pltpu.roll passes over 2 (nt + drift) shifts and the
// compile-time pass skipping.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 288;  // a row's lanes in 1-2 passes
constexpr int kMinBlocks = 4;     // CTAs an SM: 56 registers a thread at most
constexpr int kJ = 7;             // taps a block: nt - 1 = 49 a side at quality 50
constexpr int kStride = 8;        // floats a block in the taper tables (two float4)
constexpr int kScanBase = 16;     // fixed_order_cumsum's block
constexpr int kMaxLevels = 8;     // scan levels: rows up to 16**8 lanes
constexpr float kPi = 3.14159265358979323846f;  // float32(np.pi), as JAX rounds it

enum class Window { kSignal, kGathered };
enum class Grids { kPlan, kGiven };

struct Args {
  const float* src;               // signal (kSignal) or (T, L) buffer (kGathered)
  long long n_src;
  const int* base_int;            // kSignal
  const float* bs;                // kGiven: (T, max_n) grids
  const float* rel;
  const unsigned char* in_seg;
  const float* s_lo;              // kPlan: (T,) plan
  const float* s_hi;
  const int* n;
  const float* base_frac;
  float* out;
  int max_n, nt, drift;
};

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 1/e from one MUFU reciprocal and one Newton step (~1 ulp).
__device__ __forceinline__ float recip(float e) {
  const float r = rcp_approx(e);
  return fmaf(r, fmaf(-e, r, 1.0f), r);
}

// Floats of block totals a fixed-order scan of n elements needs.
__host__ __device__ int scan_scratch(int n) {
  int total = 0;
  while (n > kScanBase) {
    n = (n + kScanBase - 1) / kScanBase;
    total += n;
  }
  return total;
}

// Inclusive sequential scans of the 16-element blocks of x[0, n) in place
// (fixed_order_cumsum's innermost level); block b's total goes to tot[b].
// Threads tid, tid + nthreads, ... take one block each.
__device__ __forceinline__ void scan_blocks(float* x, int n, float* tot, int tid,
                                            int nthreads) {
  const int nb = (n + kScanBase - 1) / kScanBase;
  for (int b = tid; b < nb; b += nthreads) {
    float* blk = x + b * kScanBase;
    const int len = min(kScanBase, n - b * kScanBase);
    float v[kScanBase];  // the block in registers: its loads overlap
#pragma unroll
    for (int i = 0; i < kScanBase; ++i) v[i] = i < len ? blk[i] : 0.0f;
#pragma unroll
    for (int i = 1; i < kScanBase; ++i) v[i] = __fadd_rn(v[i - 1], v[i]);
#pragma unroll
    for (int i = 0; i < kScanBase; ++i) {
      if (i < len) blk[i] = v[i];
    }
    tot[b] = v[kScanBase - 1];
  }
}

// In-place inclusive cumsum of x[0, n) in fixed_order_cumsum's order, by
// one warp (the block totals of the per-row scan: a few dozen values);
// tmp holds the deeper levels' totals.
__device__ void fixed_order_scan_warp(float* x, int n, float* tmp) {
  const int lane = threadIdx.x & 31;
  float* lv[kMaxLevels];
  int len[kMaxLevels];
  int top = 0;
  lv[0] = x;
  len[0] = n;
  while (len[top] > kScanBase) {
    scan_blocks(lv[top], len[top], tmp, lane, 32);
    __syncwarp();
    const int nb = (len[top] + kScanBase - 1) / kScanBase;
    lv[++top] = tmp;
    len[top] = nb;
    tmp += nb;
  }
  if (lane == 0) {
    float* cur = lv[top];
    for (int i = 1; i < len[top]; ++i) cur[i] = __fadd_rn(cur[i - 1], cur[i]);
  }
  __syncwarp();
  for (int l = top - 1; l >= 0; --l) {
    float* cur = lv[l];
    const float* carry = lv[l + 1];
    for (int i = lane + kScanBase; i < len[l]; i += 32) {
      cur[i] = __fadd_rn(cur[i], carry[i / kScanBase - 1]);
    }
    __syncwarp();
  }
}

// The kJ taper values of block b of one side (a 16-byte aligned table in
// block order; every lane reads the same address, a broadcast).
__device__ __forceinline__ void block_taper(const float* tp, int b, float (&t)[kJ]) {
  static_assert(kJ == 7 && kStride == 8, "two float4 a block");
  const float4 x = reinterpret_cast<const float4*>(tp + kStride * b)[0];
  const float4 y = reinterpret_cast<const float4*>(tp + kStride * b)[1];
  t[0] = x.x; t[1] = x.y; t[2] = x.z; t[3] = x.w;
  t[4] = y.x; t[5] = y.y; t[6] = y.z;
}

// 1/e for the kJ taps of a block, e_i = e0 + dir i, from one MUFU
// reciprocal of their product (refined by one Newton step) and the prefix
// products: 1/e_i = (e_0 ... e_{i-1}) (e_{i+1} ... e_{kJ-1}) / (e_0 ... e_{kJ-1}).
// |e_i| >= 0.5 and |e_i| <= nt + kJ, so the product neither under- nor
// overflows for any nt a row's shared memory can hold.
__device__ __forceinline__ void block_recip(float e0, float sg, float (&r)[kJ]) {
  float e[kJ], p[kJ];
#pragma unroll
  for (int i = 0; i < kJ; ++i) e[i] = e0 + sg * static_cast<float>(i);
  p[0] = e[0];
#pragma unroll
  for (int i = 1; i < kJ; ++i) p[i] = p[i - 1] * e[i];
  float q = recip(p[kJ - 1]);  // 1 / (e_0 ... e_i) as i falls
#pragma unroll
  for (int i = kJ - 1; i > 0; --i) {
    r[i] = q * p[i - 1];
    q *= e[i];
  }
  r[0] = q;
}

// One side of a lane's taps: j = dir, 2 dir, ..., count dir (dir = +1 or
// -1), from the exact centre seed (s0, c0) = sin/cos(pi x_0) and the
// per-lane steps (cr[i], sr[i]) = cos/sin(i pi fc).  w[j]: the window at tap
// j; tp: the side's taper table, hann / pi of its tap t = kJ b + i (at
// j = dir (t + 1)) at tp[kStride b + i].  kClip: count only taps j in
// [j_lo, j_hi).
//
// Within a block of kJ taps from an anchor (sa, ca), sin of tap i is
// sa cr[i] + ca dir sr[i], so the block's sum is sa * sum(u_i cr[i]) +
// ca * sum(u_i dir sr[i]), u_i = window * taper * 1/e: two FMAs a tap, and
// the anchor enters once a block.
template <bool kClip>
__device__ __forceinline__ float side(const float* w, const float* tp, float shift,
                                      float s0, float c0, const float (&cr)[kJ + 1],
                                      const float (&sr)[kJ + 1], int dir, int count,
                                      int j_lo, int j_hi) {
  const float sg = static_cast<float>(dir);
  // anchor at j = dir: rotate the centre by dir * pi fc
  float sa = fmaf(s0, cr[1], sg * c0 * sr[1]);
  float ca = fmaf(c0, cr[1], -sg * s0 * sr[1]);
  float acc = 0.0f;
  int j = dir;
  const int blocks = count / kJ;
  for (int b = 0; b < blocks; ++b) {
    float t[kJ], r[kJ];
    block_taper(tp, b, t);
    block_recip(static_cast<float>(j) - shift, sg, r);
    float bc = 0.0f, bs = 0.0f;
#pragma unroll
    for (int i = 0; i < kJ; ++i) {
      const int jj = j + dir * i;
      float u;
      if (kClip) {
        u = (jj >= j_lo && jj < j_hi) ? w[jj] * (t[i] * r[i]) : 0.0f;
      } else {
        u = w[jj] * (t[i] * r[i]);
      }
      if (i == 0) {
        bc = u;
      } else {
        bc = fmaf(u, cr[i], bc);
        bs = fmaf(u, sg * sr[i], bs);
      }
    }
    acc = fmaf(sa, bc, fmaf(ca, bs, acc));
    const float sn = fmaf(sa, cr[kJ], sg * ca * sr[kJ]);
    ca = fmaf(ca, cr[kJ], -sg * sa * sr[kJ]);
    sa = sn;
    j += dir * kJ;
  }
#pragma unroll 1
  for (int i = 0; i < count - blocks * kJ; ++i) {  // the rest, rotating tap by tap
    if (!kClip || (j >= j_lo && j < j_hi)) {
      acc = fmaf(sa * w[j], tp[kStride * blocks + i] * recip(static_cast<float>(j) - shift),
                 acc);
    }
    const float sn = fmaf(sa, cr[1], sg * ca * sr[1]);
    ca = fmaf(ca, cr[1], -sg * sa * sr[1]);
    sa = sn;
    j += dir;
  }
  return acc;
}

// One side of a lane with fc = 1, where sin(pi (j - shift)) = (-1)^j s0:
// no sine work at all.  Tap i of block b has j = dir (kJ b + i + 1), so its
// sign (-1)^j is -(-1)^i, flipped where kJ b is odd; the caller multiplies
// the sum by s0.
template <bool kClip>
__device__ __forceinline__ float side_unit(const float* w, const float* tp, float shift,
                                           int dir, int count, int j_lo, int j_hi) {
  const float sg = static_cast<float>(dir);
  float acc = 0.0f;
  int j = dir;
  const int blocks = count / kJ;
  for (int b = 0; b < blocks; ++b) {
    float t[kJ], r[kJ];
    block_taper(tp, b, t);
    block_recip(static_cast<float>(j) - shift, sg, r);
    float blk = 0.0f;  // taps signed as if the block were even
#pragma unroll
    for (int i = 0; i < kJ; ++i) {
      const int jj = j + dir * i;
      const float sign = i % 2 ? 1.0f : -1.0f;
      if (!kClip || (jj >= j_lo && jj < j_hi)) blk = fmaf(sign * w[jj], t[i] * r[i], blk);
    }
    acc += (kJ * b) % 2 ? -blk : blk;
    j += dir * kJ;
  }
#pragma unroll 1
  for (int i = 0; i < count - blocks * kJ; ++i) {
    const float sign = (kJ * blocks + i) % 2 ? 1.0f : -1.0f;
    if (!kClip || (j >= j_lo && j < j_hi)) {
      acc = fmaf(sign * w[j], tp[kStride * blocks + i] * recip(static_cast<float>(j) - shift),
                 acc);
    }
    j += dir;
  }
  return acc;
}

// Both sides of a lane; kClip: only taps j in [j_lo, j_hi) count.
template <bool kClip>
__device__ __forceinline__ float sides(const float* w, const float* tplus,
                                       const float* tminus, float shift, float fc,
                                       float s0, float c0, int nt, int j_lo, int j_hi) {
  if (fc == 1.0f) {
    return s0 * (side_unit<kClip>(w, tplus, shift, 1, nt - 1, j_lo, j_hi)
                 + side_unit<kClip>(w, tminus, shift, -1, nt - 1, j_lo, j_hi));
  }
  float sf, cf;
  sincospif(fc, &sf, &cf);
  float cr[kJ + 1], sr[kJ + 1];
  cr[0] = 1.0f;
  sr[0] = 0.0f;
  cr[1] = cf;
  sr[1] = sf;
#pragma unroll
  for (int i = 2; i <= kJ; ++i) {
    cr[i] = fmaf(cr[i - 1], cf, -sr[i - 1] * sf);
    sr[i] = fmaf(sr[i - 1], cf, cr[i - 1] * sf);
  }
  return side<kClip>(w, tplus, shift, s0, c0, cr, sr, 1, nt - 1, j_lo, j_hi)
         + side<kClip>(w, tminus, shift, s0, c0, cr, sr, -1, nt - 1, j_lo, j_hi);
}

// One output lane: the centre tap and both sides.  ``win`` is the row's
// window in shared memory; ``tplus`` / ``tminus`` the two sides' tapers.
__device__ float lane(const float* win, const float* tplus, const float* tminus, float r,
                      float fc, int k, int nt, int U, int drift) {
  const float anchor = rintf(r);  // half to even, as jnp.round
  const float shift = r - anchor;
  const int a = static_cast<int>(anchor);
  const int m = a - k;
  const float* w = win + a + U;  // w[j]: the window at tap j
  const float x0 = __fmul_rn(-shift, fc);
  float s0, c0;
  sincospif(x0, &s0, &c0);
  // the centre tap: sinc(x0) fc hann_0, hann_0 = 1, with the exact seed
  const float w0 = x0 == 0.0f ? fc : s0 * fc * recip(kPi * x0);
  if (m >= -drift && m <= drift) {  // the drift contract: every tap counts
    return fmaf(w[0], w0, sides<false>(w, tplus, tminus, shift, fc, s0, c0, nt, 0, 0));
  }
  // p = a + U + j in [k, k + 2U)  <=>  j in [-U - m, U - m)
  const int j_lo = max(-nt, -U - m);
  const int j_hi = min(nt, U - m);
  const float c = (j_lo <= 0 && 0 < j_hi) ? w[0] * w0 : 0.0f;
  return c + sides<true>(w, tplus, tminus, shift, fc, s0, c0, nt, j_lo, j_hi);
}

// hann_{2nt+1}[j + nt] / pi for j in [-nt, nt), 0 outside.
__device__ __forceinline__ float taper_at(int j, int nt) {
  if (j < -nt || j >= nt) return 0.0f;
  return (0.5f - 0.5f * cospif(static_cast<float>(j + nt) / static_cast<float>(nt))) / kPi;
}

// Shared memory of a CTA, in floats, each part 16-byte aligned: two
// windows, the two sides' taper tables (whole blocks of kJ), and for the
// plan entries the fc and cumsum grids with the scan's block totals.
struct Layout {
  int win, tplus, tminus, fcs, inv, end;
  __host__ __device__ Layout(int max_n, int nt, int drift) {
    win = (max_n + 2 * (nt + drift) + 3) / 4 * 4;
    tplus = 2 * win;
    tminus = tplus + (nt - 1 + kJ - 1) / kJ * kStride;
    fcs = tminus + (nt - 1 + kJ - 1) / kJ * kStride;
    inv = fcs + (max_n + 3) / 4 * 4;
    end = inv + max_n + scan_scratch(max_n);
  }
};

// Asynchronous 4-byte copy from global to shared memory (cp.async, sm_80+).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying row ``row``'s window into ``dst`` (L floats); zeros outside
// the signal are stored directly.  ``start``: the row's first sample.
template <Window kWindow>
__device__ __forceinline__ void stage_window(const Args& g, long long row,
                                             long long start, int L, float* dst) {
  if constexpr (kWindow == Window::kSignal) {
    for (int p = threadIdx.x; p < L; p += blockDim.x) {
      const long long s = start + p;
      if (s >= 0 && s < g.n_src) {
        cp_async4(dst + p, g.src + s);
      } else {
        dst[p] = 0.0f;
      }
    }
  } else {
    const float* buf = g.src + row * L;
    for (int p = threadIdx.x; p < L; p += blockDim.x) cp_async4(dst + p, buf + p);
  }
}

// Row ``row``'s first window sample in the signal (kSignal; 0 otherwise).
template <Window kWindow>
__device__ __forceinline__ long long window_start(const Args& g, long long row, int U) {
  if constexpr (kWindow == Window::kSignal) {
    return static_cast<long long>(g.base_int[row]) - U;
  } else {
    return 0;
  }
}

// A row's plan: the endpoint speeds' lerp terms, output count, base fraction.
struct RowPlan {
  float lo, diff, denom, bf;
  int n;
};

__device__ __forceinline__ RowPlan load_plan(const Args& g, long long row) {
  const float lo = g.s_lo[row];
  const int n = g.n[row];
  return {lo, __fsub_rn(g.s_hi[row], lo), static_cast<float>(max(n - 1, 1)),
          g.base_frac[row], n};
}

// Persistent CTAs: CTA b takes rows b, b + gridDim.x, ...  While a row's
// lanes run, the next row's window streams into the other half of a
// double buffer (cp.async) and its plan or anchor loads are in flight, so
// the per-row latency (global loads, the grid scan's serial steps) overlaps
// the tap loop of the CTA and of the others on the SM.
template <Window kWindow, Grids kGrids>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) sinc_banded_kernel(Args g,
                                                                              int T) {
  extern __shared__ float smem[];
  const int nt = g.nt;
  const int U = nt + g.drift;
  const int max_n = g.max_n;
  const int L = max_n + 2 * U;
  const Layout lay(max_n, nt, g.drift);
  float* wins = smem;                 // two windows, sig[base_int - U + p]
  float* tplus = smem + lay.tplus;    // hann_{2nt+1}[j + nt] / pi at j = t + 1
  float* tminus = smem + lay.tminus;  // and at j = -(t + 1), zero past nt
  float* fcs = smem + lay.fcs;        // kPlan: min(bs, 1)
  float* inv = smem + lay.inv;        // kPlan: 1/bs, then its cumsum

  for (int q = threadIdx.x; q < lay.tminus - lay.tplus; q += blockDim.x) {
    const int t = q / kStride * kJ + q % kStride;  // the side's tap (q % kStride < kJ)
    tplus[q] = q % kStride < kJ ? taper_at(t + 1, nt) : 0.0f;
    tminus[q] = q % kStride < kJ ? taper_at(-(t + 1), nt) : 0.0f;
  }
  long long row = blockIdx.x;
  RowPlan plan{};
  if (row < T) {
    stage_window<kWindow>(g, row, window_start<kWindow>(g, row, U), L, wins);
    if constexpr (kGrids == Grids::kPlan) plan = load_plan(g, row);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int it = 0; row < T; row += gridDim.x, ++it) {
    const float* win = wins + (it & 1) * lay.win;
    const long long next = row + gridDim.x;
    long long next_start = 0;
    RowPlan next_plan{};
    if (next < T) {  // loads in flight while this row's grids are built
      next_start = window_start<kWindow>(g, next, U);
      if constexpr (kGrids == Grids::kPlan) next_plan = load_plan(g, next);
    }
    if constexpr (kGrids == Grids::kPlan) {
      for (int k = threadIdx.x; k < max_n; k += blockDim.x) {
        const float bs =
            __fadd_rn(plan.lo, __fmul_rn(__fdiv_rn(static_cast<float>(k), plan.denom),
                                         plan.diff));
        inv[k] = k < plan.n ? __fdiv_rn(1.0f, bs) : 0.0f;
        fcs[k] = fminf(bs, 1.0f);
      }
      __syncthreads();
      // rel = cumsum(inv) + bf in fixed_order_cumsum's order: the 16-blocks'
      // local scans (block-wide), the scan of their totals (warp 0), and
      // each lane adds its block's exclusive carry as it reads rel
      scan_blocks(inv, max_n, inv + max_n, threadIdx.x, blockDim.x);
      __syncthreads();
      if (threadIdx.x < 32) {
        fixed_order_scan_warp(inv + max_n, (max_n + kScanBase - 1) / kScanBase,
                              inv + max_n + (max_n + kScanBase - 1) / kScanBase);
      }
      __syncthreads();
    }
    if (next < T) {
      stage_window<kWindow>(g, next, next_start, L, wins + ((it + 1) & 1) * lay.win);
    }

    const long long base = row * max_n;
    for (int k = threadIdx.x; k < max_n; k += blockDim.x) {
      float acc = 0.0f;
      if constexpr (kGrids == Grids::kPlan) {
        if (k < plan.n) {
          const float* carry = inv + max_n;  // the totals' inclusive scan
          const float c = k < kScanBase ? inv[k] : __fadd_rn(inv[k], carry[k / kScanBase - 1]);
          acc = lane(win, tplus, tminus, __fadd_rn(c, plan.bf), fcs[k], k, nt, U, g.drift);
        }
      } else {
        if (g.in_seg[base + k]) {
          acc = lane(win, tplus, tminus, g.rel[base + k], fminf(g.bs[base + k], 1.0f), k,
                     nt, U, g.drift);
        }
      }
      g.out[base + k] = acc;
    }
    plan = next_plan;
    cp_async_wait_all();
    __syncthreads();
  }
}

template <Window kWindow, Grids kGrids>
int launch(const Args& g, int T, void* stream) {
  const Layout lay(g.max_n, g.nt, g.drift);
  const size_t smem = static_cast<size_t>(kGrids == Grids::kPlan ? lay.end : lay.fcs) *
                      sizeof(float);
  const auto kernel = sinc_banded_kernel<kWindow, kGrids>;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the fewest passes of at most kMaxThreads lanes, spread evenly
  const int passes = g.max_n > kMaxThreads ? (g.max_n + kMaxThreads - 1) / kMaxThreads : 1;
  const int threads = ((g.max_n + passes - 1) / passes + 31) / 32 * 32;
  // as many CTAs as fit on the card at once, each looping over rows
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess) {
    return static_cast<int>(e);
  }
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(T < fit ? T : fit);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(g, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry launches on ``stream`` and returns cudaGetLastError() (0 on
// success).  ``T`` rows, (T, max_n) float32 ``out``.

// K1 with the grids given: ``bs``/``rel``/``in_seg`` are (T, max_n).
extern "C" int sinc_banded_f32(const float* sig, long long n_sig, const int* base_int,
                               const float* bs, const float* rel,
                               const unsigned char* in_seg, float* out, int T,
                               int max_n, int nt, int drift, void* stream) {
  const Args g{sig, n_sig, base_int, bs, rel, in_seg, nullptr, nullptr, nullptr,
               nullptr, out, max_n, nt, drift};
  return launch<Window::kSignal, Grids::kGiven>(g, T, stream);
}

// K1 with the grids built in the kernel from the (T,) plan.
extern "C" int sinc_banded_plan_f32(const float* sig, long long n_sig,
                                    const int* base_int, const float* s_lo,
                                    const float* s_hi, const int* n,
                                    const float* base_frac, float* out, int T,
                                    int max_n, int nt, int drift, void* stream) {
  const Args g{sig, n_sig, base_int, nullptr, nullptr, nullptr, s_lo, s_hi, n,
               base_frac, out, max_n, nt, drift};
  return launch<Window::kSignal, Grids::kPlan>(g, T, stream);
}

// K2 with the grids given: ``buf`` is (T, max_n + 2 (nt + drift)), row-major.
extern "C" int sinc_banded_gathered_f32(const float* buf, const float* bs,
                                        const float* rel, const unsigned char* in_seg,
                                        float* out, int T, int max_n, int nt, int drift,
                                        void* stream) {
  const Args g{buf, 0, nullptr, bs, rel, in_seg, nullptr, nullptr, nullptr, nullptr,
               out, max_n, nt, drift};
  return launch<Window::kGathered, Grids::kGiven>(g, T, stream);
}

// K2 with the grids built in the kernel from the (T,) plan.
extern "C" int sinc_banded_gathered_plan_f32(const float* buf, const float* s_lo,
                                             const float* s_hi, const int* n,
                                             const float* base_frac, float* out, int T,
                                             int max_n, int nt, int drift,
                                             void* stream) {
  const Args g{buf, 0, nullptr, nullptr, nullptr, nullptr, s_lo, s_hi, n, base_frac,
               out, max_n, nt, drift};
  return launch<Window::kGathered, Grids::kPlan>(g, T, stream);
}
