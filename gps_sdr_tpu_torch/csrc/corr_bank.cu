// One-block correlator banks for Hopper (sm_90a): the vector-tracking hot
// path and the per-block tracker's bank over windows.
//
// corr_bank_kernel replaces the TPU kernel
// gps_sdr_tpu/ops/pallas_track.py::correlator_bank_hbm (_bank_kernel): one
// coherent block for every channel with the NCO state supplied from outside
// (the VDFLL drives the code NCO from the navigation solution once per ms,
// trackingVT_POS_updated.m:218-232).  Each channel's window is read at
// ptr_off from the int8/int16 chunk that stays in device memory, mixed with
// the Q32 carrier, masked to `num` samples, optionally freed of its mean, and
// correlated per tap against the code at that tap's offset: I and Q sums per
// tap, (N, ntaps, 2) float32.
//
// corr_bank_windows_kernel replaces the TPU kernel
// gps_sdr_tpu/ops/pallas_correlator.py::correlator_bank (_corr_kernel): the
// same bank over windows that the caller has already cut out, one (blk, 2)
// window per channel, which is what the per-block tracker (tracking.py
// track_scan) runs for every coherent block longer than 2 ms.  Both are thin
// callers of bank_block below, so their sums agree bit for bit.
//
// What bounds them on this card.  At 1 ms a launch moves ~116 KB per channel
// and does a few MFLOP, well under a microsecond of either: the floor is the
// launch (and the second kernel), and what the kernel adds is the latency of
// its set-up and of one tile's load.  At 10 ms, 8 channels move 9.3 MB,
// 2.8 us at the card's memory rate: bytes are the bound, and what the kernel
// adds is the dispatch of its per-sample instructions.  Because the NCO state is
// an input, a block's samples have no serial dependence.
//
// Design: the grid is (channel, part); a channel's 128-sample rows are split
// over `n_split` CTAs.  Every CTA makes the channel's tables (the code as
// float64, the r-phasors), so parts are not free: what measured best at 1 and
// at 10 ms is one wave with one CTA an SM (16 parts for 8 channels), fewer for
// a block so short that a part would fall under two dozen rows (the
// wrapper's default_split).  Each CTA walks its part as a ring of two 16 KB
// tiles in shared memory, filled by 16-byte asynchronous copies one tile
// ahead, and correlates them with the shared sample loop of nco_common.cuh
// (one float64 conversion per sample, the chip index kept along a thread's
// run of samples).  It reduces its float64 tap sums (warp shuffles, then the
// warps in order) into its own slot of `partial`, and a second small kernel
// adds a channel's slots in part order and rounds to float32 once: no
// floating-point atomics, so results repeat run to run.  With n_split == 1
// the first kernel writes the result itself.  A cluster per channel with a
// reduction through distributed shared memory does not replace the second
// kernel: 16 parts are more than the portable cluster of 8, and of clusters
// of 16 the card holds 7 at once (cudaOccupancyMaxActiveClusters), fewer than
// the 8 channels; partial sums would cross clusters through device memory
// all the same, for the ~1 us that the second launch costs in a graph.
//
// DC removal reads the window once more, not once per part: a small kernel
// on the same grid writes each part's integer sums (exact, order-free) into
// the part's slot, and every correlating CTA adds the channel's slots for
// the mean.  With n_split == 1 the CTA sums its tiles itself.
//
// The arithmetic is that of the exact-NCO replica (tracking.py:239-318 with
// `num` given), shared with track_chunk.cu through nco_common.cuh.  Built
// with -fmad=false it gives the plain PyTorch version's float32 results
// (ops/corr_bank.py).
//
// Nothing is clamped: a window that leaves the chunk, a block length outside
// [1, blk], or an NCO word that is not finite raises *fault to 1 + channel
// (atomicMax) and that channel's result is zero; the host raises.

#include "nco_common.cuh"

namespace {

using namespace nco;

constexpr int kTileBytes = 16384;
constexpr int kSmemBytes = 2 * kTileBytes;
constexpr int kDcThreads = 256;

struct Params {
  long long n_raw;  // samples in the chunk
  int n_ch, ntaps, n_split, blk, remove_dc;
  double fs;
};

// One channel's block as the kernels are given it; ok == false: refused.
struct Block {
  long long off;
  int num;
  double rem, step_c;
  bool ok;
};

// ptr_off == nullptr: the windows entry, channel ch's window is
// raw[ch * blk : (ch + 1) * blk], so only the block length can be out of
// range.
__device__ __forceinline__ Block block_of(const Params& p, int ch,
                                          const long long* ptr_off,
                                          const double* rem_chip,
                                          const double* code_freq,
                                          const long long* num_in) {
  Block b;
  const long long num = num_in[ch];
  b.off = ptr_off ? ptr_off[ch] : (long long)ch * p.blk;
  b.rem = rem_chip[ch];
  b.step_c = code_freq[ch] / p.fs;  // chips per sample
  b.ok = num >= 1 && num <= (long long)p.blk && b.off >= 0 &&
         b.off + num <= p.n_raw && isfinite(b.rem) && isfinite(b.step_c);
  b.num = b.ok ? (int)num : 0;
  return b;
}

// This part's samples of a block of `num`: whole 128-sample rows.
template <typename PairT>
__device__ __forceinline__ void part_share(
    Share<kTileBytes, PairT>* sh, const Params& p, const PairT* raw,
    long long off, int num) {
  const int rows = (num + 127) >> 7;
  const int rows_per = (rows + p.n_split - 1) / p.n_split;
  const long long lo = (long long)blockIdx.y * rows_per * 128;
  sh->set(raw, off, (int)min((long long)num, lo),
          (int)min((long long)num, lo + (long long)rows_per * 128));
}

// The partial sums of (channel, part): ntaps (I, Q) pairs, then the part's
// integer sums for DC removal.
__device__ __forceinline__ double* slot_of(const Params& p, double* partial,
                                           int ch, int part) {
  return partial + ((long long)ch * p.n_split + part) * 2 * (p.ntaps + 1);
}

// One channel's part of one block, the block known to be valid.  NT > 0: tap
// count fixed at compile time; NT == 0: runtime p.ntaps.  Every thread of
// the CTA calls it.
template <int NT, typename PairT>
__device__ __forceinline__ void bank_block(
    const Params& p, const PairT* __restrict__ raw, const Block& b,
    unsigned phase0, unsigned carr_fp, const float* __restrict__ chips,
    const long long* __restrict__ tap_fp, float* __restrict__ corr,
    double* __restrict__ partial) {
  typedef Share<kTileBytes, PairT> ShareT;
  typedef CorrWork<NT, kTileBytes, PairT> WorkT;
  constexpr int kWarps = threads_for(NT) / 32;
  const int ntaps = NT > 0 ? NT : p.ntaps;
  const int ch = blockIdx.x, part = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char s_tiles[];
  __shared__ double s_part[kWarps][2 * WorkT::T];
  PairT* t0 = reinterpret_cast<PairT*>(s_tiles);
  PairT* t1 = reinterpret_cast<PairT*>(s_tiles + kTileBytes);

  // the first tile's copies fly while the tables are made
  ShareT sh;
  part_share(&sh, p, raw, b.off, b.num);
  walk_start(sh, raw, p.n_raw, t0, 0);
  load_code<ShareT::kRows>(chips, tap_fp, ch, ntaps);
  load_r_phasors<ShareT::kRows>(carr_fp);

  float dc_r = 0.f, dc_i = 0.f;
  int have = 0;
  if (p.remove_dc) {  // the whole block's mean; integer sums, exact
    double a = 0.0, c = 0.0;
    if (p.n_split == 1) {
      SumWork<kTileBytes, PairT> sum(sh);
      walk(sh, raw, p.n_raw, t0, t1, sum, NoAhead());
      a = warp_sum((double)sum.sum_r);
      c = warp_sum((double)sum.sum_i);
      if (lane == 0) { s_part[warp][0] = a; s_part[warp][1] = c; }
      __syncthreads();
      a = 0.0; c = 0.0;
      for (int w = 0; w < kWarps; ++w) { a += s_part[w][0]; c += s_part[w][1]; }
      __syncthreads();  // s_part is reused by the tap reduction
      have = sh.n_tiles == 1 ? sh.need(0) : 0;  // still in shared memory
    } else {  // written by corr_bank_dc_kernel
      for (int s = 0; s < p.n_split; ++s) {
        const double* d = slot_of(p, partial, ch, s) + 2 * p.ntaps;
        a += d[0];
        c += d[1];
      }
    }
    dc_r = (float)(a / (double)b.num);
    dc_i = (float)(c / (double)b.num);
  }

  if (p.remove_dc && p.n_split == 1) walk_start(sh, raw, p.n_raw, t0, have);
  WorkT work(sh, ntaps);
  work.phase0 = phase0;
  work.carr_fp = carr_fp;
  work.base_fp = __double2ll_rn(b.rem * kQ32);
  work.step_fp = __double2ll_rn(b.step_c * kQ32);
  work.dc_r = dc_r;
  work.dc_i = dc_i;
  walk(sh, raw, p.n_raw, t0, t1, work, NoAhead());

  const double v = cta_tap_sum<NT>(work.acc_i, work.acc_q, ntaps, s_part);
  if (tid < 2 * ntaps) {
    if (p.n_split == 1)
      corr[(long long)ch * 2 * ntaps + tid] = (float)v;
    else
      slot_of(p, partial, ch, part)[tid] = v;
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
      slot_of(p, partial, ch, part)[tid] = 0.0;
  }
}

// The fetching entry: each channel's window starts at ptr_off in the chunk.
template <int NT, typename RawT>
__global__ void __launch_bounds__(threads_for(NT))
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
  const Block b = block_of(p, ch, ptr_off, rem_chip, code_freq, num_in);
  if (!b.ok) {
    refuse_block(p, corr, partial, fault);
    return;
  }
  bank_block<NT, PairT>(
      p, reinterpret_cast<const PairT*>(raw), b,
      (unsigned)(unsigned long long)phase_fp[ch],
      (unsigned)(unsigned long long)carr_fp[ch], chips, tap_fp, corr, partial);
}

// The windows entry: channel ch's window is win[ch * blk : (ch + 1) * blk],
// cut out by the caller.
template <int NT, typename RawT>
__global__ void __launch_bounds__(threads_for(NT))
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
  const Block b = block_of(p, ch, nullptr, rem_chip, code_freq, num_in);
  if (!b.ok) {
    refuse_block(p, corr, partial, fault);
    return;
  }
  bank_block<NT, PairT>(
      p, reinterpret_cast<const PairT*>(win), b,
      (unsigned)(unsigned long long)phase_fp[ch],
      (unsigned)(unsigned long long)carr_fp[ch], chips, tap_fp, corr, partial);
}

// DC removal with n_split > 1, before the correlation: each part's integer
// sums into its slot, so the window is read once for the mean.  Both entries
// (ptr_off == nullptr: windows).
template <typename RawT>
__global__ void __launch_bounds__(kDcThreads)
corr_bank_dc_kernel(Params p, const RawT* __restrict__ raw,
                    const long long* __restrict__ ptr_off,
                    const double* __restrict__ rem_chip,
                    const double* __restrict__ code_freq,
                    const long long* __restrict__ num_in,
                    double* __restrict__ partial) {
  typedef typename PairOf<RawT>::type PairT;
  typedef Share<kTileBytes, PairT> ShareT;
  constexpr int kWarps = kDcThreads / 32;
  const int ch = blockIdx.x, tid = threadIdx.x;
  const Block b = block_of(p, ch, ptr_off, rem_chip, code_freq, num_in);
  if (!b.ok) return;  // the correlating kernel refuses the channel
  extern __shared__ __align__(16) unsigned char s_tiles[];
  __shared__ double s_part[kWarps][2];
  const PairT* x = reinterpret_cast<const PairT*>(raw);
  ShareT sh;
  part_share(&sh, p, x, b.off, b.num);
  SumWork<kTileBytes, PairT> sum(sh);
  walk_start(sh, x, p.n_raw, reinterpret_cast<PairT*>(s_tiles), 0);
  walk(sh, x, p.n_raw, reinterpret_cast<PairT*>(s_tiles),
       reinterpret_cast<PairT*>(s_tiles + kTileBytes), sum, NoAhead());
  const double a = warp_sum((double)sum.sum_r);
  const double c = warp_sum((double)sum.sum_i);
  if ((tid & 31) == 0) { s_part[tid >> 5][0] = a; s_part[tid >> 5][1] = c; }
  __syncthreads();
  if (tid < 2) {
    double v = 0.0;
    for (int w = 0; w < kWarps; ++w) v += s_part[w][tid];
    slot_of(p, partial, ch, blockIdx.y)[2 * p.ntaps + tid] = v;
  }
}

// A channel's partial sums added in part order, rounded to float32 once.
__global__ void corr_bank_finish(Params p, const double* __restrict__ partial,
                                 float* __restrict__ corr) {
  const int ch = blockIdx.x, j = threadIdx.x, n_out = 2 * p.ntaps;
  if (j >= n_out) return;
  const double* src = partial + (long long)ch * p.n_split * (n_out + 2) + j;
  double v = 0.0;
  for (int s = 0; s < p.n_split; ++s) v += src[(long long)s * (n_out + 2)];
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
  if (p.remove_dc && p.n_split > 1)
    corr_bank_dc_kernel<RawT><<<grid, kDcThreads, kSmemBytes, stream>>>(
        p, r, ptr_off, rem_chip, code_freq, num, partial);
#define BANK_LAUNCH(NT)                                                       \
  if (ptr_off)                                                                \
    corr_bank_kernel<NT, RawT>                                                \
        <<<grid, threads_for(NT), kSmemBytes, stream>>>(                      \
        p, r, chips, tap_fp, ptr_off, rem_chip, code_freq, phase_fp, carr_fp, \
        num, corr, partial, fault);                                           \
  else                                                                        \
    corr_bank_windows_kernel<NT, RawT>                                        \
        <<<grid, threads_for(NT), kSmemBytes, stream>>>(                      \
            p, r, chips, tap_fp, rem_chip, code_freq, phase_fp, carr_fp, num, \
            corr, partial, fault)
  switch (p.ntaps) {
    case 3: BANK_LAUNCH(3); break;    // E/P/L
    case 25: BANK_LAUNCH(25); break;  // the CT-POS multicorrelator grid
    case 29: BANK_LAUNCH(29); break;  // the VT multicorrelator grid
    default: BANK_LAUNCH(0); break;
  }
#undef BANK_LAUNCH
  if (p.n_split > 1)
    corr_bank_finish<<<p.n_ch, 2 * kMaxTaps, 0, stream>>>(p, partial, corr);
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
// corr (n_ch, ntaps, 2) float32; partial (n_ch, n_split, ntaps + 1, 2) float64
// scratch (a part's tap sums, then its integer sums for DC removal; unused
// when n_split == 1); fault one int32, raised, never cleared.
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
