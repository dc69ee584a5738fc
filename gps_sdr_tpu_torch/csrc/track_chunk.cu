// Whole-chunk DLL/PLL tracking kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel gps_sdr_tpu/ops/pallas_track.py::fused_track_chunk
// (_fused_kernel): every coherent block of one chunk, for every channel, in
// one launch (trackingCT.m:96-150, trackingCT_POS_updated.m:210-270).
//
// What bounds it on this card: the serial block chain.  Each block's length
// and replica depend on the loop state the previous block left, and a
// receiver tracks a handful of channels, so the work is a few long serial
// chains on 132 SMs -- neither bytes (1 ms at 58 MHz is 116 KB of int8 IQ)
// nor FLOPs are the limit.
//
// Design: one CTA per channel loops over the blocks.  Each block's samples
// are striped over the CTA's threads, read straight from the int8/int16 chunk
// in device memory (no window size limit, so any pdi) and cast in registers.
// The carrier is the Q32 phasor product of the JAX scan (tracking.py:274-288):
// for sample k = 128 q + r, e^{i theta_k} = e^{i theta_q} e^{i theta_r} with
// both phases exact int32 Q32 words; the 128 r-phasors are computed once per
// block and the q-phasors once per 128 samples, into shared memory, so a
// sample costs two shared loads and four multiplies instead of a sincos.
// Every tap correlates against the code chip at the exact Q32 index
// ((base + tap + k*step - 1) >> 32) mod 1023, read from a 1023-entry table in
// shared memory.  The sums are float64 (the +-1 chip times a float32 sample
// is exact), reduced by warp shuffles and one pass over shared memory, and
// rounded to float32 once.  Thread 0 runs the discriminators and both
// 2nd-order loop filters in float64 (the TPU kernel's compensated float32
// forms existed only because the TPU emulates float64) and a barrier hands
// the new NCO state to all threads.
//
// The plain PyTorch version (ops/track_chunk.py) evaluates the same
// operations in the same order; built with -fmad=false (no contraction of
// a*b+c) and with IEEE division and sqrt, the kernel then gives the same
// float32 correlators except where a float64 sum lies within ~1e-15 of a
// float32 rounding boundary.  That matters: the loops round float64 NCO
// words to integers every block, and a difference of one rounding sends
// the two loops down different (equally valid) noise trajectories.
//
// The PLL discriminator is atan(Q/I) with the I == 0 guard, not atan2: the
// Costas loop must not see the data-bit sign.  Rounding is half to even
// (__double2ll_rn, rint) wherever the JAX scan uses jnp.round.
//
// A block whose window would leave the chunk (or whose length is not
// finite) sets *fault = 1 + channel and stops that channel; the host raises
// when it reads the records back.

#include "nco_common.cuh"

namespace {

using namespace nco;

struct Params {
  long long n_raw;        // samples in the chunk
  long long chunk_start;  // absolute sample index of raw[0]
  int n_ch, n_steps, ntaps, n_chips;
  int ceil_rounding, remove_dc;
  int i_early, i_prompt, i_late;
  double fs, code_freq_basis, sign, dll_freq_sign;
  double dll_a, dll_b, pll_a, pll_b;  // tau2/tau1 and dt/tau1 of each loop
};

struct ChanState {
  long long ptr;
  unsigned phase;  // Q32 carrier phase (int32 bit pattern)
  double rem, code_freq, carr_freq, carr_basis;
  double dll_nco, dll_last, pll_nco, pll_last;
};

// NT > 0: tap count fixed at compile time; NT == 0: runtime p.ntaps.
template <int NT, int THREADS, typename RawT>
__global__ void __launch_bounds__(THREADS)
track_chunk_kernel(Params p, const RawT* __restrict__ raw,
                   const float* __restrict__ chips,
                   const long long* __restrict__ tap_fp,
                   const long long* __restrict__ state_i,
                   const double* __restrict__ state_f,
                   float* __restrict__ corr, double* __restrict__ rec_f,
                   long long* __restrict__ rec_i,
                   long long* __restrict__ state_i_out,
                   double* __restrict__ state_f_out, int* __restrict__ fault) {
  constexpr int T = NT > 0 ? NT : kMaxTaps;
  constexpr int kWarps = THREADS / 32;
  static_assert(THREADS % 128 == 0, "a thread keeps one r-phasor");
  typedef typename PairOf<RawT>::type PairT;
  const int ntaps = NT > 0 ? NT : p.ntaps;
  const int ch = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const PairT* xs = reinterpret_cast<const PairT*>(raw);
  const long long plane = (long long)p.n_steps * p.n_ch;

  __shared__ float s_chips[kCodeLen];
  __shared__ long long s_tap[kMaxTaps];
  __shared__ float s_vc[128], s_vs[128];          // e^{i theta_r}
  __shared__ float s_uc[THREADS], s_us[THREADS];  // e^{i theta_q}, a segment
  __shared__ double s_part[kWarps][2 * kMaxTaps];
  __shared__ float s_corr[2 * kMaxTaps];
  __shared__ ChanState s;

  for (int i = tid; i < kCodeLen; i += THREADS)
    s_chips[i] = chips[(long long)ch * kCodeLen + i];
  if (tid < ntaps) s_tap[tid] = tap_fp[tid];
  if (tid == 0) {
    const double* f = state_f + ch * 8;
    s.ptr = state_i[ch * 2];
    s.phase = (unsigned)state_i[ch * 2 + 1];
    s.rem = f[0]; s.code_freq = f[1]; s.carr_freq = f[2]; s.carr_basis = f[3];
    s.dll_nco = f[4]; s.dll_last = f[5]; s.pll_nco = f[6]; s.pll_last = f[7];
  }
  __syncthreads();

  for (int step = 0; step < p.n_steps; ++step) {
    // every thread derives the block's NCO words from the same shared state
    const double rem = s.rem;
    const double step_c = s.code_freq / p.fs;           // chips per sample
    const double n_exact = ((double)p.n_chips - rem) / step_c;
    const double num_d = p.ceil_rounding ? ceil(n_exact) : rint(n_exact);
    const long long off = s.ptr - p.chunk_start;
    if (!(num_d >= 1.0 && num_d <= (double)p.n_raw) || off < 0 ||
        off + (long long)num_d > p.n_raw) {
      if (tid == 0) atomicCAS(fault, 0, ch + 1);
      break;  // uniform over the CTA: all threads read the same state
    }
    const int num = (int)num_d;
    const long long step_fp = __double2ll_rn(step_c * kQ32);
    const long long base_fp = __double2ll_rn(rem * kQ32);
    const unsigned carr_fp =
        (unsigned)(long long)__double2ll_rn(s.carr_freq / p.fs * kQ32);
    const unsigned phase0 = s.phase;
    const PairT* x = xs + off;

    if (tid < 128) r_phasor((unsigned)tid, carr_fp, &s_vc[tid], &s_vs[tid]);

    float dc_r = 0.f, dc_i = 0.f;
    if (p.remove_dc) {  // integer sums: exact in float64, order-free
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

    // segments of THREADS q-rows (THREADS*128 samples): any block length
    for (int q0 = 0; q0 * 128 < num; q0 += THREADS) {
      q_phasor(phase0, (unsigned)(q0 + tid), carr_fp, &s_uc[tid], &s_us[tid]);
      __syncthreads();  // also publishes s_vc/s_vs on the first segment
      const float vc = s_vc[tid & 127], vs = s_vs[tid & 127];
      const int kend = min(num, (q0 + THREADS) * 128);
      for (int k = q0 * 128 + tid; k < kend; k += THREADS) {
        const PairT v = x[k];
        const float xr = (float)v.x - dc_r, xi = (float)v.y - dc_i;
        float mi, mq;  // I = imag(x e^{i theta}), Q = real
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
      s_corr[tid] = (float)v * (float)p.sign;
    }
    __syncthreads();

    if (tid == 0) {
      const float* c = s_corr;
      const long long row = (long long)step * p.n_ch + ch;
      float* cr = corr + row * ntaps * 2;
      for (int j = 0; j < 2 * ntaps; ++j) cr[j] = c[j];
      const float e_i = c[2 * p.i_early], e_q = c[2 * p.i_early + 1];
      const float p_i = c[2 * p.i_prompt], p_q = c[2 * p.i_prompt + 1];
      const float l_i = c[2 * p.i_late], l_q = c[2 * p.i_late + 1];
      const double e = (double)sqrtf(e_i * e_i + e_q * e_q);
      const double l = (double)sqrtf(l_i * l_i + l_q * l_q);
      const double code_err = 0.5 * (e - l) / fmax(e + l, 1e-30);
      const double dll =
          s.dll_nco + p.dll_a * (code_err - s.dll_last) + code_err * p.dll_b;
      const double code_freq = p.code_freq_basis + p.dll_freq_sign * dll;
      const float safe_pi = p_i == 0.f ? 1e-30f : p_i;
      const double carr_err = (double)(atanf(p_q / safe_pi) / (float)kTwoPi);
      const double pll =
          s.pll_nco + p.pll_a * (carr_err - s.pll_last) + carr_err * p.pll_b;
      const double carr_freq = s.carr_basis + pll;
      const double rem_new = (double)num * step_c + rem - (double)p.n_chips;
      const unsigned phase_new = phase0 + (unsigned)num * carr_fp;
      const long long ptr_new = s.ptr + num;

      rec_f[0 * plane + row] = code_err;
      rec_f[1 * plane + row] = carr_err;
      rec_f[2 * plane + row] = code_freq;
      rec_f[3 * plane + row] = carr_freq;
      rec_f[4 * plane + row] = rem_new;
      rec_i[0 * plane + row] = num;
      rec_i[1 * plane + row] = ptr_new;
      rec_i[2 * plane + row] = (long long)(int)phase_new;

      s.ptr = ptr_new; s.phase = phase_new; s.rem = rem_new;
      s.code_freq = code_freq; s.carr_freq = carr_freq;
      s.dll_nco = dll; s.dll_last = code_err;
      s.pll_nco = pll; s.pll_last = carr_err;
    }
    __syncthreads();
  }

  if (tid == 0) {
    double* f = state_f_out + ch * 8;
    state_i_out[ch * 2] = s.ptr;
    state_i_out[ch * 2 + 1] = (long long)(int)s.phase;
    f[0] = s.rem; f[1] = s.code_freq; f[2] = s.carr_freq; f[3] = s.carr_basis;
    f[4] = s.dll_nco; f[5] = s.dll_last; f[6] = s.pll_nco; f[7] = s.pll_last;
  }
}

template <typename RawT>
void launch(const Params& p, const void* raw, const float* chips,
            const long long* tap_fp, const long long* state_i,
            const double* state_f, float* corr, double* rec_f, long long* rec_i,
            long long* state_i_out, double* state_f_out, int* fault,
            cudaStream_t stream) {
  const RawT* r = static_cast<const RawT*>(raw);
  const dim3 grid(p.n_ch);
  // 3 taps: 512 threads; more taps: 256, so the float64 sums stay in registers
#define TRACK_LAUNCH(NT, THREADS)                                           \
  track_chunk_kernel<NT, THREADS, RawT><<<grid, THREADS, 0, stream>>>(      \
      p, r, chips, tap_fp, state_i, state_f, corr, rec_f, rec_i, state_i_out, \
      state_f_out, fault)
  switch (p.ntaps) {
    case 3: TRACK_LAUNCH(3, 512); break;    // E/P/L (epl, pos_epl)
    case 25: TRACK_LAUNCH(25, 256); break;  // the CT-POS multicorrelator grid
    default: TRACK_LAUNCH(0, 256); break;
  }
#undef TRACK_LAUNCH
}

}  // namespace

// iparams: n_ch, n_steps, ntaps, n_chips, ceil_rounding, remove_dc,
//          i_early, i_prompt, i_late
// fparams: fs, code_freq_basis, sign, dll_freq_sign, then tau2/tau1 and
//          dt/tau1 of the DLL and of the PLL
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int track_chunk_launch(
    const void* raw, int raw_int16, long long n_raw, long long chunk_start,
    const float* chips, const long long* tap_fp, const long long* state_i,
    const double* state_f, float* corr, double* rec_f, long long* rec_i,
    long long* state_i_out, double* state_f_out, int* fault,
    const int* iparams, const double* fparams, void* stream) {
  Params p;
  p.n_raw = n_raw;
  p.chunk_start = chunk_start;
  p.n_ch = iparams[0]; p.n_steps = iparams[1]; p.ntaps = iparams[2];
  p.n_chips = iparams[3]; p.ceil_rounding = iparams[4]; p.remove_dc = iparams[5];
  p.i_early = iparams[6]; p.i_prompt = iparams[7]; p.i_late = iparams[8];
  p.fs = fparams[0]; p.code_freq_basis = fparams[1]; p.sign = fparams[2];
  p.dll_freq_sign = fparams[3]; p.dll_a = fparams[4]; p.dll_b = fparams[5];
  p.pll_a = fparams[6]; p.pll_b = fparams[7];
  if (p.n_ch < 1 || p.ntaps < 1 || p.ntaps > kMaxTaps || p.n_steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (raw_int16)
    launch<int16_t>(p, raw, chips, tap_fp, state_i, state_f, corr, rec_f, rec_i,
                    state_i_out, state_f_out, fault, st);
  else
    launch<int8_t>(p, raw, chips, tap_fp, state_i, state_f, corr, rec_f, rec_i,
                   state_i_out, state_f_out, fault, st);
  return (int)cudaGetLastError();
}

extern "C" const char* track_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
