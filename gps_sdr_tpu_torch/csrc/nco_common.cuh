// What the receiver's three correlator kernels share: the Q32 carrier
// phasors, the mix of one IQ sample, the staging of samples through shared
// memory, and the one sample loop that correlates a staged tile.
//
// On this card a correlator is bound by instruction dispatch and by the latency
// of its loads, not by bytes or float32 operations: a block of 58 000 samples
// is 116 KB.  The design answers both.
//
// - Samples reach the loop through tiles in shared memory, filled by 16-byte
//   asynchronous copies (cp.async) that are started one tile ahead, so no
//   thread waits on device memory for the samples it is about to use.  A
//   window starts at any sample, so a tile's origin is the window's address
//   rounded down to 16 bytes; what lies before the first or after the last
//   wanted sample is masked, and 16-byte pieces that would leave the chunk
//   are copied pair by pair instead (the copy is clamped, never the block).
// - A thread takes 16 bytes (8 int8 pairs, 4 int16 pairs) of consecutive
//   samples.  Along such a run the Q32 chip index is kept relative to the
//   run's first sample: one `mod 1023` per run, then per sample and tap the
//   high word of a 64-bit add plus a bias, corrected only where it leaves
//   [0, 1023).  The index is the exact ((base + tap + k*step - 1) >> 32) mod
//   1023 (floor for negatives) of the plain versions.
// - The mixed sample is converted to float64 once; every tap adds the chip
//   (a float64 table in shared memory) times that double with one fma.  A
//   float32 chip times a float32 sample is exact in float64, so the fma is
//   the plain version's code.to(f64) * iq.to(f64), summed.
//
// The float32 terms are those of the plain PyTorch versions
// (ops/track_chunk.py, ops/corr_bank.py): same operations, same order, built
// with -fmad=false so that nothing contracts a*b+c.  Which thread sums which
// sample differs from the plain versions and between grid shapes; the
// float64 sum of these terms rounds to the same float32 whatever the order
// (held by tests/test_torch_kernel_design.py and on the card by
// chip_smoke.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nco {

constexpr int kCodeLen = 1023;
constexpr int kMaxTaps = 32;
// Threads of a correlator CTA: with few taps the float64 sums leave room
// for 16 warps an SM, which hide the loop's latencies better than 8.
__host__ __device__ constexpr int threads_for(int nt) { return nt > 0 && nt <= 4 ? 512 : 256; }
constexpr double kQ32 = 4294967296.0;
constexpr double kTwoPi = 6.283185307179586;
constexpr float kToRad = (float)(kTwoPi / kQ32);  // one Q32 LSB in radians

template <typename RawT> struct PairOf;
template <> struct PairOf<int8_t> { typedef char2 type; };
template <> struct PairOf<int16_t> { typedef short2 type; };

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Carrier phasors of sample k = 128 q + r (the JAX scan's outer product,
// tracking.py:274-288): e^{i theta_k} = e^{i theta_q} e^{i theta_r}, both
// phases exact int32 Q32 words that wrap mod one cycle.
__device__ __forceinline__ void r_phasor(unsigned r, unsigned carr_fp,
                                         float* c, float* s) {
  const float ph = (float)(int)(r * carr_fp) * kToRad;
  *c = cosf(ph);
  *s = sinf(ph);
}

__device__ __forceinline__ void q_phasor(unsigned phase0, unsigned q,
                                         unsigned carr_fp, float* c,
                                         float* s) {
  const float ph = (float)(int)(phase0 + q * (carr_fp * 128u)) * kToRad;
  *c = cosf(ph);
  *s = sinf(ph);
}

// One sample (xr, xi) times e^{i theta_k}: I = imag, Q = real
// (trackingCT.m:113).
__device__ __forceinline__ void mix(float xr, float xi, float uc, float us,
                                    float vc, float vs, float* mi,
                                    float* mq) {
  const float c = uc * vc - us * vs;   // cos theta_k
  const float sn = uc * vs + us * vc;  // sin theta_k
  *mi = xr * sn + xi * c;
  *mq = xr * c - xi * sn;
}

__device__ __forceinline__ int floor_mod_code(int v) {
  int ci = v % kCodeLen;
  ci += ci < 0 ? kCodeLen : 0;
  return ci;
}

// IQ pair `j` of a 32-bit word of samples: two int8 pairs or one int16 pair.
__device__ __forceinline__ void unpack(char2, unsigned w, int j, int* re,
                                       int* im) {
  const unsigned h = w >> (16 * j);
  *re = (int)(signed char)(h & 0xffu);
  *im = (int)(signed char)((h >> 8) & 0xffu);
}

__device__ __forceinline__ void unpack(short2, unsigned w, int, int* re,
                                       int* im) {
  *re = (int)(short)(w & 0xffffu);
  *im = (int)(short)(w >> 16);
}

// ---- asynchronous 16-byte copies into shared memory ----

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's youngest groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Absolute pair index `a` of the chunk rounded down to a 16-byte address.
template <typename PairT>
__device__ __forceinline__ long long align_down16(const PairT* raw,
                                                  long long a) {
  const unsigned long long addr = (unsigned long long)(raw + a);
  return a - (long long)((addr & 15ull) / sizeof(PairT));
}

// Copy pairs [a_from, a_to) of the chunk (absolute pair indices; a_from on a
// 16-byte address, a_to - a_from a whole number of 16-byte pieces) into the
// tile whose first pair is a0.  Pieces inside [0, n_raw) go by cp.async;
// a piece that would leave the chunk is copied pair by pair, zeros outside.
// Every thread of the CTA calls it; the caller commits and waits.
template <typename PairT>
__device__ __forceinline__ void stage(PairT* tile, long long a0,
                                      long long a_from, long long a_to,
                                      const PairT* __restrict__ raw,
                                      long long n_raw) {
  constexpr int G = 16 / (int)sizeof(PairT);
  const int n_vec = a_to > a_from ? (int)((a_to - a_from) / G) : 0;
  for (int c = threadIdx.x; c < n_vec; c += blockDim.x) {
    const long long a = a_from + (long long)c * G;
    PairT* dst = tile + (a - a0);
    if (a >= 0 && a + G <= n_raw) {
      cp_async16(dst, raw + a);
    } else {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        PairT v;
        v.x = 0; v.y = 0;
        if (a + j >= 0 && a + j < n_raw) v = raw[a + j];
        dst[j] = v;
      }
    }
  }
}

// ---- one CTA's share of one block, walked as tiles ----

// Samples [k_lo, k_hi) of the block whose first pair is raw[off].  The tile
// origin a0 is off + k_lo rounded down to 16 bytes; tile i holds the pairs
// [a0 + i*TP, a0 + (i+1)*TP).
template <int TILE_BYTES, typename PairT>
struct Share {
  static constexpr int TP = TILE_BYTES / (int)sizeof(PairT);  // pairs a tile
  static constexpr int G = 16 / (int)sizeof(PairT);
  static constexpr int kRows = TP / 128 + 2;  // 128-sample rows a tile meets
  long long off, a0;
  int k_lo, k_hi, n_tiles;

  __device__ __forceinline__ void set(const PairT* raw, long long off_,
                                      int k_lo_, int k_hi_) {
    off = off_; k_lo = k_lo_; k_hi = k_hi_;
    a0 = align_down16(raw, off + k_lo);
    n_tiles = k_hi > k_lo ? (int)((off + k_hi - a0 + TP - 1) / TP) : 0;
  }
  // pairs of tile i that the share wants, rounded up to whole pieces
  __device__ __forceinline__ int need(int i) const {
    if (i >= n_tiles) return 0;
    const long long rest = off + k_hi - (a0 + (long long)i * TP);
    return (int)min((long long)TP, (rest + G - 1) / G * G);
  }
  // block-sample range of tile i, clipped to the share
  __device__ __forceinline__ int tile_k0(int i) const {
    return (int)(a0 + (long long)i * TP - off);
  }
  __device__ __forceinline__ int t_lo(int i) const {
    return max(k_lo, tile_k0(i));
  }
  __device__ __forceinline__ int t_hi(int i) const {
    return min(k_hi, tile_k0(i) + TP);
  }
};

// Walk a share: tile i is staged while tile i-1 is worked on, in two buffers
// that alternate.  walk_start starts tile 0's copies (`have` pairs of it are
// already in buf0, 0 when none were staged ahead); the caller may do other
// set-up before it calls walk, which waits for them.  `ahead()` may start
// more copies that stay in flight through the walk (the next block's first
// tile): it is called after tile 0's copies are committed and commits its
// own group.  Work is a functor:
// prepare(i) before tile i's data is awaited (no tile data, only tables),
// run(tile, i) on the staged tile.  Every thread of the CTA calls it; on
// return all tiles are consumed by this thread, not by all (the caller's next
// barrier orders that).
template <int TILE_BYTES, typename PairT>
__device__ __forceinline__ void walk_start(const Share<TILE_BYTES, PairT>& sh,
                                           const PairT* __restrict__ raw,
                                           long long n_raw, PairT* buf0,
                                           int have) {
  const int need0 = sh.need(0);
  if (need0 > have) stage(buf0, sh.a0, sh.a0 + have, sh.a0 + need0, raw, n_raw);
  cp_async_commit();
}

template <int TILE_BYTES, typename PairT, typename Work, typename Ahead>
__device__ __forceinline__ void walk(const Share<TILE_BYTES, PairT>& sh,
                                     const PairT* __restrict__ raw,
                                     long long n_raw, PairT* buf0,
                                     PairT* buf1, Work& work, Ahead ahead) {
  constexpr int TP = Share<TILE_BYTES, PairT>::TP;
  work.prepare(0);
  ahead();
  cp_async_wait<1>();  // all but ahead()'s group: tile 0 has landed
  __syncthreads();
  for (int i = 0; i < sh.n_tiles; ++i) {
    PairT* cur = (i & 1) ? buf1 : buf0;
    const bool more = i + 1 < sh.n_tiles;
    if (more) {
      const long long a1 = sh.a0 + (long long)(i + 1) * TP;
      stage((i & 1) ? buf0 : buf1, a1, a1, a1 + sh.need(i + 1), raw, n_raw);
      cp_async_commit();
      work.prepare(i + 1);
    }
    work.run(cur, i);
    if (more) {
      cp_async_wait<0>();
      __syncthreads();
    }
  }
}

struct NoAhead {
  __device__ __forceinline__ void operator()() const { cp_async_commit(); }
};

// The integer sums of a share (DC removal): exact, so order-free.
template <int TILE_BYTES, typename PairT>
struct SumWork {
  const Share<TILE_BYTES, PairT>& sh;
  long long sum_r = 0, sum_i = 0;
  __device__ __forceinline__ explicit SumWork(
      const Share<TILE_BYTES, PairT>& s) : sh(s) {}
  __device__ __forceinline__ void prepare(int) {}
  __device__ __forceinline__ void run(const PairT* tile, int i) {
    constexpr int G = Share<TILE_BYTES, PairT>::G;
    const int k0t = sh.tile_k0(i), lo = sh.t_lo(i), hi = sh.t_hi(i);
    const int g_hi = (hi - k0t + G - 1) / G;
    for (int g = (lo - k0t) / G + threadIdx.x; g < g_hi; g += blockDim.x) {
      const uint4 v = *reinterpret_cast<const uint4*>(tile + g * G);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
      const int k0 = k0t + g * G;
      int a = 0, b = 0;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        int re, im;
        unpack(PairT(), w[j / (G / 4)], j % (G / 4), &re, &im);
        if (k0 + j >= lo && k0 + j < hi) { a += re; b += im; }
      }
      sum_r += a;
      sum_i += b;
    }
  }
};

// What the sample loop reads from shared memory.  The code table is
// extended by kPad chips on either side, so that an index relative to a run's
// first sample needs no wrap while it stays within the pad.  The r-phasors
// are stored at r + (r >> 3): lanes of a warp are 8 (or 4) samples apart, and
// the padding spreads them over the banks.
constexpr int kPad = 64;
// The padded table, one entry more so that it is whole 16-byte pieces:
// entry i is chip (i - kPad) mod 1023.
constexpr int kTableLen = kPad + kCodeLen + kPad + 1;
// The tap words: kMaxTaps Q32 offsets (zeros past the last tap), then the
// least and the largest of them.
constexpr int kTapWords = kMaxTaps + 2;

template <int ROWS>
struct __align__(16) CorrTables {
  double chips[kTableLen];       // this channel's code, as float64
  long long tap[kTapWords];      // the tap words
  float2 v[128 + 16];            // e^{i theta_r}: (cos, sin)
  float2 u[2][ROWS];  // e^{i theta_q} of a tile's rows, two tiles
};

// One object per kernel; named where it is used, so that its addresses are
// constants of the shared window and no pointer to it is carried about.
template <int ROWS>
__device__ __forceinline__ CorrTables<ROWS>& corr_tables() {
  __shared__ CorrTables<ROWS> tb;
  return tb;
}

__device__ __forceinline__ int v_slot(int r) { return r + (r >> 3); }

// The sample loop: correlates a share's staged tiles against every tap.
// NT > 0: tap count fixed at compile time; NT == 0: run-time `ntaps`.
template <int NT, int TILE_BYTES, typename PairT>
struct CorrWork {
  typedef Share<TILE_BYTES, PairT> ShareT;
  static constexpr int T = NT > 0 ? NT : kMaxTaps;
  static constexpr int G = ShareT::G;
  static constexpr bool kFewTaps = NT > 0 && NT <= 4;  // taps in registers
  const ShareT& sh;
  int ntaps;
  unsigned phase0, carr_fp;
  long long base_fp, step_fp;
  float dc_r, dc_i;
  double acc_i[T], acc_q[T];

  __device__ __forceinline__ CorrWork(const ShareT& s, int nt)
      : sh(s), ntaps(NT > 0 ? NT : nt) {
#pragma unroll
    for (int t_ = 0; t_ < T; ++t_) { acc_i[t_] = 0.0; acc_q[t_] = 0.0; }
  }

  // the q-phasors of tile i's rows, into the half of `u` that tile i-1 does
  // not read
  __device__ __forceinline__ void prepare(int i) {
    CorrTables<ShareT::kRows>& tb = corr_tables<ShareT::kRows>();
    const int lo = sh.t_lo(i), hi = sh.t_hi(i);
    if (hi <= lo) return;
    const int q0 = lo >> 7, nq = ((hi - 1) >> 7) - q0 + 1;
    for (int j = threadIdx.x; j < nq; j += blockDim.x) {
      float c, s;
      q_phasor(phase0, (unsigned)(q0 + j), carr_fp, &c, &s);
      tb.u[i & 1][j] = make_float2(c, s);
    }
  }

  // One run of G consecutive samples from k0, the 16 bytes `x`.  Samples
  // outside [lo, hi) add zeros.  `bias` turns the high word of kb + tap into
  // an index of the padded table; SAFE: every index of the run is known to
  // stay inside it, else each is wrapped.  With few taps the four words are
  // unrolled code, with many a loop.
  template <bool SAFE>
  __device__ __forceinline__ void run_of_samples(uint4 x, int k0, int lo,
                                                 int hi, int q0, int half,
                                                 long long kb, int bias,
                                                 const long long* tap_r) {
    CorrTables<ShareT::kRows>& tb = corr_tables<ShareT::kRows>();
    const bool whole = k0 >= lo && k0 + G <= hi;
#pragma unroll(kFewTaps && SAFE ? 4 : 1)
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int j = 0; j < G / 4; ++j) {
        const int k = k0 + w * (G / 4) + j;
        const bool live = whole || (k >= lo && k < hi);
        int re, im;
        unpack(PairT(), x.x, j, &re, &im);
        const float xr = (float)re - dc_r;
        const float xi = (float)im - dc_i;
        const float2 uq = tb.u[half][max((k >> 7) - q0, 0)];
        const float2 vr = tb.v[v_slot(k & 127)];
        float mi, mq;
        mix(xr, xi, uq.x, uq.y, vr.x, vr.y, &mi, &mq);
        const double di = (double)(live ? mi : 0.f);
        const double dq = (double)(live ? mq : 0.f);
#pragma unroll
        for (int t_ = 0; t_ < T; ++t_) {
          if (NT > 0 || t_ < ntaps) {
            const long long tap = kFewTaps ? tap_r[t_] : tb.tap[t_];
            int ci = (int)((kb + tap) >> 32) + bias;
            if (!SAFE) ci = floor_mod_code(ci - kPad) + kPad;
            const double cv = tb.chips[ci];
            acc_i[t_] = fma(cv, di, acc_i[t_]);
            acc_q[t_] = fma(cv, dq, acc_q[t_]);
          }
        }
        kb += step_fp;
      }
      x.x = x.y; x.y = x.z; x.z = x.w;  // the next word
    }
  }

  __device__ __forceinline__ void run(const PairT* tile, int i) {
    CorrTables<ShareT::kRows>& tb = corr_tables<ShareT::kRows>();
    const int k0t = sh.tile_k0(i), lo = sh.t_lo(i), hi = sh.t_hi(i);
    if (hi <= lo) return;
    const int q0 = lo >> 7;
    long long tap_r[kFewTaps ? T : 1];
    if (kFewTaps) {
#pragma unroll
      for (int t_ = 0; t_ < T; ++t_) tap_r[t_] = tb.tap[t_];
    }
    const long long tap_lo = tb.tap[kMaxTaps], tap_hi = tb.tap[kMaxTaps + 1];
    const long long span = (long long)(G - 1) * step_fp;
    const int g_hi = (hi - k0t + G - 1) / G;
    for (int g = (lo - k0t) / G + threadIdx.x; g < g_hi; g += blockDim.x) {
      const uint4 x = *reinterpret_cast<const uint4*>(tile + g * G);
      const int k0 = k0t + g * G;
      // the run's chip index, relative to its first sample: one mod per run
      const long long kb = base_fp + (long long)k0 * step_fp - 1;
      const int hi0 = (int)(kb >> 32);
      const int bias = floor_mod_code(hi0) - hi0 + kPad;
      const int first = (int)((min(kb, kb + span) + tap_lo) >> 32) + bias;
      const int last = (int)((max(kb, kb + span) + tap_hi) >> 32) + bias;
      if (first >= 0 && last < kCodeLen + 2 * kPad)
        run_of_samples<true>(x, k0, lo, hi, q0, i & 1, kb, bias, tap_r);
      else
        run_of_samples<false>(x, k0, lo, hi, q0, i & 1, kb, bias, tap_r);
    }
  }
};

// A CTA's tables: the channel's code and the taps (once per channel), the
// r-phasors (once per block).  The caller's next barrier publishes them.
// load_code makes the code table from the float32 chips, which a kernel that
// runs a whole chunk in one launch does once; fetch_tables copies tables
// that were made once per track (the banks, which are launched per block).
template <int ROWS>
__device__ __forceinline__ void load_code(const float* __restrict__ chips,
                                          const long long* __restrict__ tap_fp,
                                          int ch, int ntaps) {
  CorrTables<ROWS>& tb = corr_tables<ROWS>();
  for (int i = threadIdx.x; i < kTableLen; i += blockDim.x)
    tb.chips[i] = (double)chips[(long long)ch * kCodeLen +
                                floor_mod_code(i - kPad)];
  if (threadIdx.x < ntaps) tb.tap[threadIdx.x] = tap_fp[threadIdx.x];
  if (threadIdx.x == 0) {
    long long lo = tap_fp[0], hi = tap_fp[0];
    for (int t_ = 1; t_ < ntaps; ++t_) {
      lo = min(lo, tap_fp[t_]);
      hi = max(hi, tap_fp[t_]);
    }
    tb.tap[kMaxTaps] = lo;
    tb.tap[kMaxTaps + 1] = hi;
  }
}

// The same tables from device memory, where they were made once: `code` is
// this channel's kTableLen float64 entries, `taps` the kTapWords tap words,
// both on 16-byte addresses.  Started as 16-byte asynchronous copies that
// join the calling thread's open cp.async group (the first tile's), so the
// wait for that tile is the wait for the tables.  Every thread calls it.
template <int ROWS>
__device__ __forceinline__ void fetch_tables(
    const double* __restrict__ code, const long long* __restrict__ taps) {
  CorrTables<ROWS>& tb = corr_tables<ROWS>();
  constexpr int kCodePieces = kTableLen / 2, kTapPieces = kTapWords / 2;
  static_assert(kTableLen % 2 == 0 && kTapWords % 2 == 0, "16-byte pieces");
  for (int c = threadIdx.x; c < kCodePieces + kTapPieces; c += blockDim.x) {
    if (c < kCodePieces)
      cp_async16(&tb.chips[2 * c], code + 2 * c);
    else
      cp_async16(&tb.tap[2 * (c - kCodePieces)],
                 taps + 2 * (c - kCodePieces));
  }
}

template <int ROWS>
__device__ __forceinline__ void load_r_phasors(unsigned carr_fp) {
  CorrTables<ROWS>& tb = corr_tables<ROWS>();
  if (threadIdx.x < 128) {
    float c, s;
    r_phasor(threadIdx.x, carr_fp, &c, &s);
    tb.v[v_slot(threadIdx.x)] = make_float2(c, s);
  }
}

// The CTA's sum of per-thread tap sums: warp shuffles, then the warps in
// order.  Threads tid < 2*ntaps return element tid (I and Q interleaved);
// `part` is (warps of the CTA) x 2*T doubles of shared memory.  Holds two
// barriers, the first of which also closes the sample loop.
template <int NT, int T>
__device__ __forceinline__ double cta_tap_sum(const double (&acc_i)[T],
                                              const double (&acc_q)[T],
                                              int ntaps,
                                              double (*part)[2 * T]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int t_ = 0; t_ < T; ++t_) {
    if (NT > 0 || t_ < ntaps) {
      const double a = warp_sum(acc_i[t_]);
      const double b = warp_sum(acc_q[t_]);
      if (lane == 0) { part[warp][2 * t_] = a; part[warp][2 * t_ + 1] = b; }
    }
  }
  __syncthreads();
  double v = 0.0;
  if (tid < 2 * ntaps) {
    for (int w = 0; w < (int)blockDim.x / 32; ++w) v += part[w][tid];
  }
  __syncthreads();  // `part` may be reused
  return v;
}

}  // namespace nco
