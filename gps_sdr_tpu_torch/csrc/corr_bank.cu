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
// launch, and what the kernel adds is a chain of latencies (the block's
// words, one tile's load, a barrier, one run of samples per thread, the sum
// over the CTA, the sum over the channel's parts).  At 10 ms, 8 channels
// move 9.3 MB, 2.8 us at the card's memory rate: bytes are the bound, and
// what the kernel adds is the dispatch of its per-sample instructions.
// Because the NCO state is an input, a block's samples have no serial
// dependence.
//
// Design, for a kernel that is launched once per block: one launch gives the
// result, nothing that stays the same from block to block is made again,
// and the host passes only what changes.
// - The grid is (channel, part); a channel's 128-sample rows are split over
//   `n_split` CTAs, one wave with one CTA an SM (16 parts for 8 channels),
//   fewer for a block so short that a part would fall under two dozen rows
//   (the wrapper's default_split).  Each CTA walks its part as a ring of two
//   16 KB tiles in shared memory, filled by 16-byte asynchronous copies one
//   tile ahead, and correlates them with the shared sample loop of
//   nco_common.cuh (one float64 conversion per sample, the chip index kept
//   along a thread's run of samples).
// - The channel's code table (float64, padded by 64 chips a side and
//   wrapped) and the tap words (the taps, their least and largest) are made
//   once per track by the wrapper (bank_tables) and copied into shared
//   memory by the same 16-byte asynchronous copies, in the first tile's
//   group: no CTA converts or wraps a chip.  Only the 128 r-phasors, which
//   depend on the block's carrier word, are made per launch, while the
//   copies fly.
// - A CTA reduces its float64 tap sums (warp shuffles, then the warps in
//   order) into its own slot of `partial`; then it takes a ticket of its
//   channel (an integer atomicAdd behind a __threadfence), and the CTA that
//   draws the last ticket adds the channel's slots in part order, rounds to
//   float32 once, and puts the ticket back to zero for the next launch.  No
//   second kernel, no floating-point atomics: results repeat run to run and
//   equal the plain version's bit for bit.  With n_split == 1 the CTA writes
//   the result itself.
//   The other way to one launch, a thread-block cluster per channel whose
//   ranks write their sums into rank 0's shared memory and rank 0 adds them
//   in rank order after one cluster barrier, gave the same bits and was
//   slower at both tap counts (a cluster holds at most the portable 8
//   parts); kernel_ablation.py builds it again as a variant, PERF.md has its
//   times.
// - What a launch needs besides the six per-block words is one struct
//   (CorrBankArgs) that the wrapper fills once per chunk, so the host's
//   side of a launch is three arguments.
//
// DC removal reads the window once more, not once per part: a small kernel
// on the same grid, launched first, writes each part's integer sums (exact,
// order-free) into the part's slot, and every correlating CTA adds the
// channel's slots for the mean.  With n_split == 1 the CTA sums its tiles
// itself.
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

}  // namespace

// What a prepared launch keeps from one launch to the next: everything but
// the six per-block words.  ops/corr_bank.py mirrors it field for field
// (`_LaunchArgs`); pointers first, then the 8-byte scalars, then the ints.
struct CorrBankArgs {
  const void* raw;        // the chunk (n_raw, 2), or the windows (n_ch, blk, 2)
  const double* code;     // (n_ch, kTableLen) padded float64 code tables
  const long long* taps;  // (kTapWords,) tap words
  float* corr;            // (n_ch, ntaps, 2) result
  double* partial;  // (n_ch, n_split, ntaps + 1, 2) scratch: a part's tap sums,
                    // then its integer sums for DC removal
  int* ticket;      // (n_ch,) zeros: how many parts of a channel have arrived
  int* fault;       // one int32, raised, never cleared
  long long n_raw;  // samples in the chunk
  double fs;
  int raw_int16, windows, n_ch, ntaps, n_split, blk, remove_dc;
  int threads;  // of a correlating CTA, a multiple of 32 in [128, threads_for]
  int device;   // the ordinal of the card that holds the tensors
};

namespace {

typedef CorrBankArgs Params;

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
__device__ __forceinline__ double* slot_of(const Params& p, int ch, int part) {
  return p.partial + ((long long)ch * p.n_split + part) * 2 * (p.ntaps + 1);
}

// One channel's part of one block, the block known to be valid.  NT > 0: tap
// count fixed at compile time; NT == 0: runtime p.ntaps.  Every thread of
// the CTA calls it.
template <int NT, typename PairT>
__device__ __forceinline__ void bank_block(const Params& p, const Block& b,
                                           unsigned phase0,
                                           unsigned carr_fp) {
  typedef Share<kTileBytes, PairT> ShareT;
  typedef CorrWork<NT, kTileBytes, PairT> WorkT;
  constexpr int kWarps = threads_for(NT) / 32;
  const int ntaps = NT > 0 ? NT : p.ntaps;
  const int ch = blockIdx.x, part = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const PairT* raw = static_cast<const PairT*>(p.raw);

  extern __shared__ __align__(16) unsigned char s_tiles[];
  __shared__ double s_part[kWarps][2 * WorkT::T];
  __shared__ int s_last;
  PairT* t0 = reinterpret_cast<PairT*>(s_tiles);
  PairT* t1 = reinterpret_cast<PairT*>(s_tiles + kTileBytes);

  // the tables and the first tile are one group of copies; the r-phasors
  // are made while they fly
  ShareT sh;
  part_share(&sh, p, raw, b.off, b.num);
  fetch_tables<ShareT::kRows>(p.code + (long long)ch * kTableLen, p.taps);
  walk_start(sh, raw, p.n_raw, t0, 0);
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
      for (int w = 0; w < (int)blockDim.x / 32; ++w) {
        a += s_part[w][0];
        c += s_part[w][1];
      }
      __syncthreads();  // s_part is reused by the tap reduction
      have = sh.n_tiles == 1 ? sh.need(0) : 0;  // still in shared memory
    } else {  // written by corr_bank_dc_kernel
      for (int s = 0; s < p.n_split; ++s) {
        const double* d = slot_of(p, ch, s) + 2 * p.ntaps;
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
  float* out = p.corr + (long long)ch * 2 * ntaps;
  if (p.n_split == 1) {
    if (tid < 2 * ntaps) out[tid] = (float)v;
  } else {
    // every part into its slot; the part that arrives last (an integer
    // ticket per channel, which it puts back to zero for the next launch)
    // adds the slots in part order
    if (tid < 2 * ntaps) {
      slot_of(p, ch, part)[tid] = v;
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      s_last = atomicAdd(p.ticket + ch, 1) == p.n_split - 1;
    }
    __syncthreads();
    if (s_last) {
      __threadfence();
      if (tid < 2 * ntaps) {
        double total = 0.0;
        for (int s = 0; s < p.n_split; ++s)
          total += __ldcg(slot_of(p, ch, s) + tid);
        out[tid] = (float)total;
      }
      if (tid == 0) p.ticket[ch] = 0;
    }
  }
}

// A refused channel: the flag raised to 1 + channel, zeros written.  The
// condition is uniform over the channel's CTAs, which return after this
// (none takes a ticket).
__device__ __forceinline__ void refuse_block(const Params& p) {
  const int ch = blockIdx.x, part = blockIdx.y, tid = threadIdx.x;
  if (part != 0) return;
  if (tid == 0) atomicMax(p.fault, ch + 1);
  if (tid < 2 * p.ntaps) p.corr[(long long)ch * 2 * p.ntaps + tid] = 0.f;
}

// The fetching entry: each channel's window starts at ptr_off in the chunk.
template <int NT, typename RawT>
__global__ void __launch_bounds__(threads_for(NT))
corr_bank_kernel(Params p, const long long* __restrict__ ptr_off,
                 const double* __restrict__ rem_chip,
                 const double* __restrict__ code_freq,
                 const long long* __restrict__ phase_fp,
                 const long long* __restrict__ carr_fp,
                 const long long* __restrict__ num_in) {
  typedef typename PairOf<RawT>::type PairT;
  const int ch = blockIdx.x;
  const Block b = block_of(p, ch, ptr_off, rem_chip, code_freq, num_in);
  if (!b.ok) {
    refuse_block(p);
    return;
  }
  bank_block<NT, PairT>(p, b, (unsigned)(unsigned long long)phase_fp[ch],
                        (unsigned)(unsigned long long)carr_fp[ch]);
}

// The windows entry: channel ch's window is win[ch * blk : (ch + 1) * blk],
// cut out by the caller.
template <int NT, typename RawT>
__global__ void __launch_bounds__(threads_for(NT))
corr_bank_windows_kernel(Params p, const double* __restrict__ rem_chip,
                         const double* __restrict__ code_freq,
                         const long long* __restrict__ phase_fp,
                         const long long* __restrict__ carr_fp,
                         const long long* __restrict__ num_in) {
  typedef typename PairOf<RawT>::type PairT;
  const int ch = blockIdx.x;
  const Block b = block_of(p, ch, nullptr, rem_chip, code_freq, num_in);
  if (!b.ok) {
    refuse_block(p);
    return;
  }
  bank_block<NT, PairT>(p, b, (unsigned)(unsigned long long)phase_fp[ch],
                        (unsigned)(unsigned long long)carr_fp[ch]);
}

// DC removal with n_split > 1, before the correlation: each part's integer
// sums into its slot, so the window is read once for the mean.  Both entries
// (ptr_off == nullptr: windows).
template <typename RawT>
__global__ void __launch_bounds__(kDcThreads)
corr_bank_dc_kernel(Params p, const long long* __restrict__ ptr_off,
                    const double* __restrict__ rem_chip,
                    const double* __restrict__ code_freq,
                    const long long* __restrict__ num_in) {
  typedef typename PairOf<RawT>::type PairT;
  typedef Share<kTileBytes, PairT> ShareT;
  constexpr int kWarps = kDcThreads / 32;
  const int ch = blockIdx.x, tid = threadIdx.x;
  const Block b = block_of(p, ch, ptr_off, rem_chip, code_freq, num_in);
  if (!b.ok) return;  // the correlating kernel refuses the channel
  extern __shared__ __align__(16) unsigned char s_tiles[];
  __shared__ double s_part[kWarps][2];
  const PairT* x = static_cast<const PairT*>(p.raw);
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
    slot_of(p, ch, blockIdx.y)[2 * p.ntaps + tid] = v;
  }
}

__global__ void empty_kernel() {}

// The correlating kernel of one entry, tap count and sample type, launched
// on `stream`, one CTA for each (channel, part).  A CTA's static and dynamic shared memory together pass 48 KB, which a
// kernel has to be allowed once per card.
cudaError_t launch_kernel(const void* func, unsigned long long* allowed,
                          const Params& p, void** args, cudaStream_t stream) {
  if (!(*allowed >> p.device & 1ull)) {
    cudaError_t rc = cudaFuncSetAttribute(
        func, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (rc != cudaSuccess) return rc;
    *allowed |= 1ull << p.device;
  }
  return cudaLaunchKernel(func, dim3(p.n_ch, p.n_split), dim3(p.threads), args,
                          kSmemBytes, stream);
}

// words: ptr_off (unused by the windows entry), rem_chip, code_freq,
// phase_fp, carr_fp, num.
template <typename RawT>
cudaError_t launch(const Params& p, const void* const* words,
                   cudaStream_t stream) {
  const long long* ptr_off =
      p.windows ? nullptr : static_cast<const long long*>(words[0]);
  if (p.remove_dc && p.n_split > 1)
    corr_bank_dc_kernel<RawT>
        <<<dim3(p.n_ch, p.n_split), kDcThreads, kSmemBytes, stream>>>(
            p, ptr_off, static_cast<const double*>(words[1]),
            static_cast<const double*>(words[2]),
            static_cast<const long long*>(words[5]));
  Params q = p;
  void* fetch_args[] = {&q, (void*)&words[0], (void*)&words[1],
                        (void*)&words[2], (void*)&words[3], (void*)&words[4],
                        (void*)&words[5]};
  void* window_args[] = {&q, (void*)&words[1], (void*)&words[2],
                         (void*)&words[3], (void*)&words[4],
                         (void*)&words[5]};
#define BANK_LAUNCH(KERNEL, NT, ARGS)                                        \
  {                                                                          \
    static unsigned long long allowed = 0;                                   \
    if (p.threads > threads_for(NT)) return cudaErrorInvalidValue;           \
    return launch_kernel((const void*)KERNEL<NT, RawT>, &allowed, p, ARGS,   \
                         stream);                                            \
  }
  if (p.windows) {
    switch (p.ntaps) {
      case 3: BANK_LAUNCH(corr_bank_windows_kernel, 3, window_args)    // E/P/L
      case 25: BANK_LAUNCH(corr_bank_windows_kernel, 25, window_args)  // CT-POS
      default: BANK_LAUNCH(corr_bank_windows_kernel, 0, window_args)
    }
  }
  switch (p.ntaps) {
    case 3: BANK_LAUNCH(corr_bank_kernel, 3, fetch_args)    // E/P/L
    case 29: BANK_LAUNCH(corr_bank_kernel, 29, fetch_args)  // the VT grid
    default: BANK_LAUNCH(corr_bank_kernel, 0, fetch_args)
  }
#undef BANK_LAUNCH
}

}  // namespace

// One block of every channel from a prepared launch: `a` as CorrBankArgs
// describes it, `words` the six per-channel tensors of this block in the
// order ptr_off, rem_chip, code_freq, phase_fp, carr_fp, num (int64; the
// phase words are taken mod 2^32; rem_chip and code_freq float64; ptr_off is
// not read when a->windows).  Launches on `stream` on the card a->device,
// does not synchronise, returns the launch's error.
extern "C" int corr_bank_launch(const CorrBankArgs* a,
                                const void* const* words, void* stream) {
  const Params& p = *a;
  if (p.n_ch < 1 || p.ntaps < 1 || p.ntaps > kMaxTaps || p.n_split < 1 ||
      p.n_split > 65535 || p.blk < 1 || p.threads < 128 || p.threads % 32 ||
      p.device < 0 || p.device > 63)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t rc = cudaGetDevice(&current);
  if (rc != cudaSuccess) return (int)rc;
  if (current != p.device && (rc = cudaSetDevice(p.device)) != cudaSuccess)
    return (int)rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rc = p.raw_int16 ? launch<int16_t>(p, words, st)
                   : launch<int8_t>(p, words, st);
  if (rc == cudaSuccess) rc = cudaGetLastError();
  if (current != p.device) cudaSetDevice(current);
  return (int)rc;
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
