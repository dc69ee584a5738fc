// One-block correlator bank for Hopper (sm_90a): the vector-tracking hot path.
//
// Replaces the TPU kernel gps_sdr_tpu/ops/pallas_track.py::correlator_bank_hbm
// (_bank_kernel): one coherent block for every channel with the NCO state
// supplied from outside (the VDFLL drives the code NCO from the navigation
// solution once per ms, trackingVT_POS_updated.m:218-232).  Each channel's
// window is read at ptr_off from the int8/int16 chunk that stays in device
// memory, mixed with the Q32 carrier, masked to `num` samples, optionally
// freed of its mean, and correlated per tap against the code at that tap's
// offset: I and Q sums per tap, (N, ntaps, 2) float32.
//
// What bounds it on this card: one launch moves ~116 KB per channel and does
// a few MFLOP, well under a microsecond of either, so the bound is the launch
// itself; what the kernel adds on top is the latency of one block's samples
// walked by too few threads.  Because the NCO state is an input here, a
// block's samples have no serial dependence: the grid is (channel, part), a
// channel's 128-sample rows split over `n_split` CTAs, so 8 channels fill the
// card's SMs instead of 8 of them.  Each CTA reduces its float64 tap sums
// (warp shuffles, then the warps in order) into its own slot of `partial`,
// and a second small kernel adds a channel's slots in part order and rounds
// to float32 once: no floating-point atomics, so results repeat run to run.
// With n_split == 1 the first kernel writes the result itself.
//
// The arithmetic is that of the exact-NCO replica (tracking.py:239-318 with
// `num` given), shared with track_chunk.cu through nco_common.cuh: the Q32
// phasor-product carrier, chip index ((base + tap + k*step - 1) >> 32) mod
// 1023 from a 1023-entry shared table, float64 sums of exact +-1*sample
// products.  Built with -fmad=false it gives the plain PyTorch version's
// float32 results (ops/corr_bank.py) except where a float64 sum lies within
// ~1e-15 of a float32 rounding boundary.
//
// Nothing is clamped: a window that leaves the chunk, a block length outside
// [1, blk], or an NCO word that is not finite raises *fault to 1 + channel
// (atomicMax) and that channel's result is zero; the host raises.
//
// A second entry point, corr_bank_windows_kernel, replaces the TPU kernel
// gps_sdr_tpu/ops/pallas_correlator.py::correlator_bank (_corr_kernel): the
// same bank over windows that the caller has already cut out, one (blk, 2)
// window per channel, which is what the per-block tracker (tracking.py
// track_scan) runs for every coherent block longer than 2 ms.  It shares
// bank_block below, so its sums are those of the fetching entry bit for bit.
// A 10 ms block at 58 MHz is 1.16 MB per channel (int8): 8 channels move
// 9.3 MB, 2.8 us at the card's memory rate, so bytes bound it, not the
// launch; the (channel, part) grid is what spreads 8 channels over the SMs.

#include "nco_common.cuh"

namespace {

using namespace nco;

struct Params {
  long long n_raw;  // samples in the chunk
  int n_ch, ntaps, n_split, blk, remove_dc;
  double fs;
};

// One channel's part of one block: `x` points at the block's first IQ pair,
// the block is known to be valid.  NT > 0: tap count fixed at compile time;
// NT == 0: runtime p.ntaps.  Every thread of the CTA calls it.
template <int NT, int THREADS, typename PairT>
__device__ __forceinline__ void bank_block(
    const Params& p, const PairT* __restrict__ x, int num, double rem,
    double step_c, unsigned phase0, unsigned carr_fp,
    const float* __restrict__ chips, const long long* __restrict__ tap_fp,
    float* __restrict__ corr, double* __restrict__ partial) {
  constexpr int T = NT > 0 ? NT : kMaxTaps;
  constexpr int kWarps = THREADS / 32;
  static_assert(THREADS % 128 == 0, "a thread keeps one r-phasor");
  const int ntaps = NT > 0 ? NT : p.ntaps;
  const int ch = blockIdx.x, part = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ float s_chips[kCodeLen];
  __shared__ long long s_tap[kMaxTaps];
  __shared__ float s_vc[128], s_vs[128];          // e^{i theta_r}
  __shared__ float s_uc[THREADS], s_us[THREADS];  // e^{i theta_q}, a segment
  __shared__ double s_part[kWarps][2 * kMaxTaps];

  // this CTA's slot: the result itself, or its partial sums
  float* out_f = corr + (long long)ch * 2 * ntaps;
  double* out_d = partial + ((long long)ch * p.n_split + part) * 2 * ntaps;

  const long long step_fp = __double2ll_rn(step_c * kQ32);
  const long long base_fp = __double2ll_rn(rem * kQ32);
  // this part's 128-sample rows
  const int rows = (num + 127) >> 7;
  const int rows_per = (rows + p.n_split - 1) / p.n_split;
  const int q_lo = part * rows_per;
  const int q_hi = min(rows, q_lo + rows_per);

  for (int i = tid; i < kCodeLen; i += THREADS)
    s_chips[i] = chips[(long long)ch * kCodeLen + i];
  if (tid < ntaps) s_tap[tid] = tap_fp[tid];
  if (tid < 128) r_phasor((unsigned)tid, carr_fp, &s_vc[tid], &s_vs[tid]);

  float dc_r = 0.f, dc_i = 0.f;
  if (p.remove_dc) {  // the whole block's mean; integer sums, exact in float64
    double a = 0.0, b = 0.0;
    for (int k = tid; k < num; k += THREADS) {
      const PairT v = x[k];
      a += (double)v.x;
      b += (double)v.y;
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) { s_part[warp][0] = a; s_part[warp][1] = b; }
    __syncthreads();
    a = 0.0; b = 0.0;
    for (int w = 0; w < kWarps; ++w) { a += s_part[w][0]; b += s_part[w][1]; }
    dc_r = (float)(a / (double)num);
    dc_i = (float)(b / (double)num);
    __syncthreads();  // s_part is reused by the tap reduction
  }

  double acc_i[T], acc_q[T];
#pragma unroll
  for (int t = 0; t < T; ++t) { acc_i[t] = 0.0; acc_q[t] = 0.0; }

  // segments of THREADS q-rows, so any block length and any split
  for (int q0 = q_lo; q0 < q_hi; q0 += THREADS) {
    q_phasor(phase0, (unsigned)(q0 + tid), carr_fp, &s_uc[tid], &s_us[tid]);
    __syncthreads();  // also publishes s_chips, s_tap, s_vc/s_vs
    const float vc = s_vc[tid & 127], vs = s_vs[tid & 127];
    const int kend = min(num, min(q_hi, q0 + THREADS) * 128);
    for (int k = q0 * 128 + tid; k < kend; k += THREADS) {
      const PairT v = x[k];
      const float xr = (float)v.x - dc_r, xi = (float)v.y - dc_i;
      float mi, mq;
      mix(xr, xi, s_uc[(k >> 7) - q0], s_us[(k >> 7) - q0], vc, vs, &mi, &mq);
      const long long kb = base_fp + (long long)k * step_fp - 1;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (NT > 0 || t < ntaps) {
          const float cv = s_chips[chip_index(kb, s_tap[t])];
          acc_i[t] += (double)(cv * mi);
          acc_q[t] += (double)(cv * mq);
        }
      }
    }
    __syncthreads();  // segment's phasors consumed before they change
  }

#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (NT > 0 || t < ntaps) {
      const double a = warp_sum(acc_i[t]);
      const double b = warp_sum(acc_q[t]);
      if (lane == 0) { s_part[warp][2 * t] = a; s_part[warp][2 * t + 1] = b; }
    }
  }
  __syncthreads();
  if (tid < 2 * ntaps) {
    double v = 0.0;
    for (int w = 0; w < kWarps; ++w) v += s_part[w][tid];
    if (p.n_split == 1) out_f[tid] = (float)v; else out_d[tid] = v;
  }
}

// A refused channel: the flag raised to 1 + channel, zeros written.  The
// condition is uniform over the CTA, which returns after this.
__device__ __forceinline__ void refuse_block(const Params& p, float* corr,
                                             double* partial, int* fault) {
  const int ch = blockIdx.x, part = blockIdx.y, tid = threadIdx.x;
  if (tid == 0 && part == 0) atomicMax(fault, ch + 1);
  if (tid < 2 * p.ntaps) {
    if (p.n_split == 1)
      corr[(long long)ch * 2 * p.ntaps + tid] = 0.f;
    else
      partial[((long long)ch * p.n_split + part) * 2 * p.ntaps + tid] = 0.0;
  }
}

// The fetching entry: each channel's window starts at ptr_off in the chunk.
template <int NT, int THREADS, typename RawT>
__global__ void __launch_bounds__(THREADS)
corr_bank_kernel(Params p, const RawT* __restrict__ raw,
                 const float* __restrict__ chips,
                 const long long* __restrict__ tap_fp,
                 const long long* __restrict__ ptr_off,
                 const double* __restrict__ rem_chip,
                 const double* __restrict__ code_freq,
                 const long long* __restrict__ phase_fp,
                 const long long* __restrict__ carr_fp,
                 const long long* __restrict__ num_in,
                 float* __restrict__ corr, double* __restrict__ partial,
                 int* __restrict__ fault) {
  typedef typename PairOf<RawT>::type PairT;
  const int ch = blockIdx.x;
  const long long off = ptr_off[ch];
  const long long num = num_in[ch];
  const double rem = rem_chip[ch];
  const double step_c = code_freq[ch] / p.fs;  // chips per sample
  if (!(num >= 1 && num <= (long long)p.blk) || off < 0 ||
      off + num > p.n_raw || !isfinite(rem) || !isfinite(step_c)) {
    refuse_block(p, corr, partial, fault);
    return;
  }
  bank_block<NT, THREADS, PairT>(
      p, reinterpret_cast<const PairT*>(raw) + off, (int)num, rem, step_c,
      (unsigned)(unsigned long long)phase_fp[ch],
      (unsigned)(unsigned long long)carr_fp[ch], chips, tap_fp, corr, partial);
}

// The windows entry: channel ch's window is win[ch * blk : (ch + 1) * blk],
// cut out by the caller, so only the block length can be out of range.
template <int NT, int THREADS, typename RawT>
__global__ void __launch_bounds__(THREADS)
corr_bank_windows_kernel(Params p, const RawT* __restrict__ win,
                         const float* __restrict__ chips,
                         const long long* __restrict__ tap_fp,
                         const double* __restrict__ rem_chip,
                         const double* __restrict__ code_freq,
                         const long long* __restrict__ phase_fp,
                         const long long* __restrict__ carr_fp,
                         const long long* __restrict__ num_in,
                         float* __restrict__ corr,
                         double* __restrict__ partial,
                         int* __restrict__ fault) {
  typedef typename PairOf<RawT>::type PairT;
  const int ch = blockIdx.x;
  const long long num = num_in[ch];
  const double rem = rem_chip[ch];
  const double step_c = code_freq[ch] / p.fs;  // chips per sample
  if (!(num >= 1 && num <= (long long)p.blk) || !isfinite(rem) ||
      !isfinite(step_c)) {
    refuse_block(p, corr, partial, fault);
    return;
  }
  bank_block<NT, THREADS, PairT>(
      p, reinterpret_cast<const PairT*>(win) + (long long)ch * p.blk, (int)num,
      rem, step_c, (unsigned)(unsigned long long)phase_fp[ch],
      (unsigned)(unsigned long long)carr_fp[ch], chips, tap_fp, corr, partial);
}

// A channel's partial sums added in part order, rounded to float32 once.
__global__ void corr_bank_finish(int n_split, int n_out,
                                 const double* __restrict__ partial,
                                 float* __restrict__ corr) {
  const int ch = blockIdx.x, j = threadIdx.x;
  if (j >= n_out) return;
  const double* src = partial + (long long)ch * n_split * n_out + j;
  double v = 0.0;
  for (int s = 0; s < n_split; ++s) v += src[(long long)s * n_out];
  corr[(long long)ch * n_out + j] = (float)v;
}

__global__ void empty_kernel() {}

// ptr_off == nullptr selects the windows entry (raw is then the windows).
template <typename RawT>
void launch(const Params& p, const void* raw, const float* chips,
            const long long* tap_fp, const long long* ptr_off,
            const double* rem_chip, const double* code_freq,
            const long long* phase_fp, const long long* carr_fp,
            const long long* num, float* corr, double* partial, int* fault,
            cudaStream_t stream) {
  const RawT* r = static_cast<const RawT*>(raw);
  const dim3 grid(p.n_ch, p.n_split);
#define BANK_LAUNCH(NT)                                                       \
  if (ptr_off)                                                                \
    corr_bank_kernel<NT, 256, RawT><<<grid, 256, 0, stream>>>(                \
        p, r, chips, tap_fp, ptr_off, rem_chip, code_freq, phase_fp, carr_fp, \
        num, corr, partial, fault);                                           \
  else                                                                        \
    corr_bank_windows_kernel<NT, 256, RawT><<<grid, 256, 0, stream>>>(        \
        p, r, chips, tap_fp, rem_chip, code_freq, phase_fp, carr_fp, num,     \
        corr, partial, fault)
  switch (p.ntaps) {
    case 3: BANK_LAUNCH(3); break;    // E/P/L
    case 25: BANK_LAUNCH(25); break;  // the CT-POS multicorrelator grid
    case 29: BANK_LAUNCH(29); break;  // the VT multicorrelator grid
    default: BANK_LAUNCH(0); break;
  }
#undef BANK_LAUNCH
  if (p.n_split > 1)
    corr_bank_finish<<<p.n_ch, 2 * kMaxTaps, 0, stream>>>(
        p.n_split, 2 * p.ntaps, partial, corr);
}

int launch_checked(Params p, const void* raw, int raw_int16,
                   const float* chips, const long long* tap_fp,
                   const long long* ptr_off, const double* rem_chip,
                   const double* code_freq, const long long* phase_fp,
                   const long long* carr_fp, const long long* num, float* corr,
                   double* partial, int* fault, void* stream) {
  if (p.n_ch < 1 || p.ntaps < 1 || p.ntaps > kMaxTaps || p.n_split < 1 ||
      p.n_split > 65535 || p.blk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (raw_int16)
    launch<int16_t>(p, raw, chips, tap_fp, ptr_off, rem_chip, code_freq,
                    phase_fp, carr_fp, num, corr, partial, fault, st);
  else
    launch<int8_t>(p, raw, chips, tap_fp, ptr_off, rem_chip, code_freq,
                   phase_fp, carr_fp, num, corr, partial, fault, st);
  return (int)cudaGetLastError();
}

}  // namespace

// raw (n_raw, 2) int8 or int16; chips (n_ch, 1023) float32; tap_fp (ntaps,)
// Q32 tap offsets; per channel ptr_off, phase_fp, carr_fp, num (int64; the
// phase words are taken mod 2^32) and rem_chip, code_freq (float64).
// corr (n_ch, ntaps, 2) float32; partial (n_ch, n_split, ntaps, 2) float64
// scratch (unused when n_split == 1); fault one int32, raised, never cleared.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int corr_bank_launch(
    const void* raw, int raw_int16, long long n_raw, const float* chips,
    const long long* tap_fp, const long long* ptr_off, const double* rem_chip,
    const double* code_freq, const long long* phase_fp,
    const long long* carr_fp, const long long* num, float* corr,
    double* partial, int* fault, int n_ch, int ntaps, int n_split, int blk,
    int remove_dc, double fs, void* stream) {
  if (!ptr_off) return (int)cudaErrorInvalidValue;
  Params p;
  p.n_raw = n_raw;
  p.n_ch = n_ch; p.ntaps = ntaps; p.n_split = n_split; p.blk = blk;
  p.remove_dc = remove_dc; p.fs = fs;
  return launch_checked(p, raw, raw_int16, chips, tap_fp, ptr_off, rem_chip,
                        code_freq, phase_fp, carr_fp, num, corr, partial,
                        fault, stream);
}

// The bank over windows already cut out: win (n_ch, blk, 2) int8 or int16,
// contiguous; the other arguments as corr_bank_launch.
extern "C" int corr_bank_windows_launch(
    const void* win, int win_int16, const float* chips,
    const long long* tap_fp, const double* rem_chip, const double* code_freq,
    const long long* phase_fp, const long long* carr_fp, const long long* num,
    float* corr, double* partial, int* fault, int n_ch, int ntaps,
    int n_split, int blk, int remove_dc, double fs, void* stream) {
  Params p;
  p.n_raw = (long long)n_ch * blk;
  p.n_ch = n_ch; p.ntaps = ntaps; p.n_split = n_split; p.blk = blk;
  p.remove_dc = remove_dc; p.fs = fs;
  return launch_checked(p, win, win_int16, chips, tap_fp, nullptr, rem_chip,
                        code_freq, phase_fp, carr_fp, num, corr, partial,
                        fault, stream);
}

// One launch of a kernel that does nothing: the card's launch floor, which
// is this bank's bound.
extern "C" int corr_bank_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* corr_bank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
