// Whole-chunk DLL/PLL tracking kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel gps_sdr_tpu/ops/pallas_track.py::fused_track_chunk
// (_fused_kernel): every coherent block of one chunk, for every channel, in
// one launch (trackingCT.m:96-150, trackingCT_POS_updated.m:210-270).
//
// What bounds it on this card: a block's length and replica depend on the
// loop state the previous block left, so blocks of one channel are serial,
// and a receiver tracks a handful of channels.  Within a block, though, the
// samples are independent, and the time of a block is the dispatch of its
// per-sample instructions on however many SMs share it, plus the latency of
// its loads, plus what closes the block (a reduction, a barrier, the loop
// filters).  Bytes (1 ms at 58 MHz is 116 KB of int8 IQ) and float32
// operations are far below the card's rates.
//
// Design: a thread-block cluster per channel.  The grid is (channel, rank)
// with the cluster along the rank axis; rank r of C takes a contiguous share
// of the block's 128-sample rows (the last rank what remains up to `num`),
// correlates it with the shared sample loop of nco_common.cuh (16-byte
// asynchronous copies into shared memory, one float64 conversion per sample,
// the chip index kept along a thread's run of samples), reduces its float64
// tap sums in the CTA, and writes them into every rank's shared memory
// through distributed shared memory, into the slot of the block's parity.
// One cluster barrier per block; then every rank adds the C slots in rank
// order, rounds to float32 once and closes both loops itself: the same
// float64 arithmetic on the same numbers gives every thread of every rank
// the same state, in registers, so nothing is handed back and no second
// barrier is needed.  Two parity slots suffice because no rank can be more
// than one barrier ahead.  Rank 0 writes the records.
//
// The next block is staged while this one is correlated: its start
// (ptr + num) is known at the top of a block and its length to within a few
// samples, so each rank starts the copies of the first tile of its share of
// block n+1 before it works on block n.  The share boundaries of block n+1
// are fixed then, from block n's length; whatever rows the final `num` adds
// or drops fall to the last rank, and a tile that was staged short is topped
// up when the block begins.  A share larger than a tile (a 10 ms block, or
// C = 1) is walked as a ring of tiles with the same copies, so any pdi.
// With DC removal each rank first sums its share's integers (exact), the
// cluster adds them in one more exchange, and the correlation pass reuses
// the tile in shared memory when the share is one tile.
//
// The plain PyTorch version (ops/track_chunk.py) evaluates the same float32
// operations in the same order; built with -fmad=false (no contraction of
// a*b+c) and with IEEE division and sqrt, the kernel gives the same float32
// correlators: the float64 sum of the exact products rounds to the same
// float32 in any order.  That matters: the loops round float64 NCO words to
// integers every block, and a difference of one rounding sends two loops
// down different (equally valid) noise trajectories.
//
// The PLL discriminator is atan(Q/I) with the I == 0 guard, not atan2: the
// Costas loop must not see the data-bit sign.  Rounding is half to even
// (__double2ll_rn, rint) wherever the JAX scan uses jnp.round.
//
// A block whose window would leave the chunk (or whose length is not
// finite) sets *fault = 1 + channel and stops that channel: every rank of
// the cluster holds the same state, so all leave at the same block, and the
// host raises when it reads the records back.

#include <cooperative_groups.h>

#include "nco_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace nco;

constexpr int kMaxCluster = 16;
// a rank's share of a 1 ms block at 58 MHz on 8 ranks is 14.5 KB of int8
// pairs, 29 KB of int16: one tile.  Three tiles: this block's ring of two
// and the next block's first.
constexpr int kTileBytes = 32768;
constexpr int kSmemBytes = 3 * kTileBytes;
// samples staged past the end the last rank's share is predicted to have
constexpr int kMargin = 256;

struct Params {
  long long n_raw;        // samples in the chunk
  long long chunk_start;  // absolute sample index of raw[0]
  int n_ch, n_steps, ntaps, n_chips;
  int ceil_rounding, remove_dc;
  int i_early, i_prompt, i_late;
  int cluster;            // CTAs per channel
  double fs, code_freq_basis, sign, dll_freq_sign;
  double dll_a, dll_b, pll_a, pll_b;  // tau2/tau1 and dt/tau1 of each loop
};

// Rank `rank` of `c` ranks: its samples [lo, hi) of a block of `num` samples
// whose shares were laid out for a block of `num_geom` samples.  Ranks but
// the last take whole 128-sample rows; the last takes what remains.
__device__ __forceinline__ void rank_share(int num, int num_geom, int rank,
                                           int c, int* lo, int* hi) {
  const int rows_per = (((num_geom + 127) >> 7) + c - 1) / c;
  const long long w = (long long)rows_per * 128;
  *lo = (int)min((long long)num, rank * w);
  *hi = rank == c - 1 ? num : (int)min((long long)num, (rank + 1) * w);
}

// NT > 0: tap count fixed at compile time; NT == 0: runtime p.ntaps.
template <int NT, typename RawT>
__global__ void __launch_bounds__(threads_for(NT))
track_chunk_kernel(Params p, const RawT* __restrict__ raw,
                   const float* __restrict__ chips,
                   const long long* __restrict__ tap_fp,
                   const long long* __restrict__ state_i,
                   const double* __restrict__ state_f,
                   float* __restrict__ corr, double* __restrict__ rec_f,
                   long long* __restrict__ rec_i,
                   long long* __restrict__ state_i_out,
                   double* __restrict__ state_f_out, int* __restrict__ fault) {
  typedef typename PairOf<RawT>::type PairT;
  typedef Share<kTileBytes, PairT> ShareT;
  typedef CorrWork<NT, kTileBytes, PairT> WorkT;
  constexpr int kWarps = threads_for(NT) / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_rank = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ntaps = NT > 0 ? NT : p.ntaps;
  const int ch = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const PairT* xs = reinterpret_cast<const PairT*>(raw);
  const long long plane = (long long)p.n_steps * p.n_ch;

  extern __shared__ __align__(16) unsigned char s_tiles[];
  __shared__ double s_part[kWarps][2 * WorkT::T];
  // what the ranks exchange, by block parity: tap sums and integer sums
  __shared__ double s_x[2][kMaxCluster][2 * kMaxTaps];
  __shared__ double s_dc[2][kMaxCluster][2];

  // the loop state, the same in every thread of the cluster
  long long ptr = state_i[ch * 2];
  unsigned phase = (unsigned)state_i[ch * 2 + 1];  // Q32 carrier phase
  const double* f = state_f + ch * 8;
  double rem = f[0], code_freq = f[1], carr_freq = f[2];
  const double carr_basis = f[3];
  double dll_nco = f[4], dll_last = f[5], pll_nco = f[6], pll_last = f[7];

  load_code<ShareT::kRows>(chips, tap_fp, ch, ntaps);

  int num_geom = 0;         // the block length the shares were laid out for
  long long ahead_a0 = 0;   // what was staged ahead for the next block:
  int ahead_have = 0;       // tile origin and pairs
  int slot = 0;             // rotates the three tiles

  for (int step = 0; step < p.n_steps; ++step) {
    const double step_c = code_freq / p.fs;             // chips per sample
    const double n_exact = ((double)p.n_chips - rem) / step_c;
    const double num_d = p.ceil_rounding ? ceil(n_exact) : rint(n_exact);
    const long long off = ptr - p.chunk_start;
    if (!(num_d >= 1.0 && num_d <= (double)p.n_raw) || off < 0 ||
        off + (long long)num_d > p.n_raw) {
      if (rank == 0 && tid == 0) atomicCAS(fault, 0, ch + 1);
      break;  // uniform over the cluster: every thread holds the same state
    }
    const int num = (int)num_d;
    if (step == 0) num_geom = num;
    const unsigned carr_fp =
        (unsigned)(long long)__double2ll_rn(carr_freq / p.fs * kQ32);
    const int par = step & 1;

    int k_lo, k_hi;
    rank_share(num, num_geom, rank, n_rank, &k_lo, &k_hi);
    ShareT sh;
    sh.set(xs, off, k_lo, k_hi);
    int have = (ahead_have > 0 && ahead_a0 == sh.a0) ? ahead_have : 0;
    PairT* t_cur = reinterpret_cast<PairT*>(s_tiles + (slot % 3) * kTileBytes);
    PairT* t_ring =
        reinterpret_cast<PairT*>(s_tiles + ((slot + 1) % 3) * kTileBytes);
    PairT* t_next =
        reinterpret_cast<PairT*>(s_tiles + ((slot + 2) % 3) * kTileBytes);
    slot += 2;

    load_r_phasors<ShareT::kRows>(carr_fp);

    // the first tile of this rank's share of the next block, which starts
    // at off + num and is laid out for a block of `num` samples
    auto ahead = [&]() {
      ahead_have = 0;
      if (step + 1 < p.n_steps) {
        int lo, hi;
        rank_share(num + kMargin, num, rank, n_rank, &lo, &hi);
        if (lo < num && lo < hi) {
          const long long a0 = align_down16(xs, off + num + lo);
          const long long want = off + num + hi - a0;
          const int n = (int)min((long long)ShareT::TP,
                                 (want + ShareT::G - 1) / ShareT::G * ShareT::G);
          stage(t_next, a0, a0, a0 + n, xs, p.n_raw);
          ahead_a0 = a0;
          ahead_have = n;
        }
      }
      cp_async_commit();
    };

    float dc_r = 0.f, dc_i = 0.f;
    if (p.remove_dc) {  // integer sums: exact in float64, order-free
      SumWork<kTileBytes, PairT> sum(sh);
      walk_start(sh, xs, p.n_raw, t_cur, have);
      walk(sh, xs, p.n_raw, t_cur, t_ring, sum, NoAhead());
      const double a = warp_sum((double)sum.sum_r);
      const double b = warp_sum((double)sum.sum_i);
      if (lane == 0) { s_part[warp][0] = a; s_part[warp][1] = b; }
      __syncthreads();
      if (tid < 2) {
        double v = 0.0;
        for (int w = 0; w < kWarps; ++w) v += s_part[w][tid];
        for (int r = 0; r < n_rank; ++r)
          *cluster.map_shared_rank(&s_dc[par][rank][tid], r) = v;
      }
      cluster.sync();
      double sum_r = 0.0, sum_i = 0.0;
      for (int r = 0; r < n_rank; ++r) {
        sum_r += s_dc[par][r][0];
        sum_i += s_dc[par][r][1];
      }
      dc_r = (float)(sum_r / (double)num);
      dc_i = (float)(sum_i / (double)num);
      // a share of one tile is still in shared memory
      have = sh.n_tiles == 1 ? sh.need(0) : 0;
    }

    WorkT work(sh, ntaps);
    work.phase0 = phase;
    work.carr_fp = carr_fp;
    work.base_fp = __double2ll_rn(rem * kQ32);
    work.step_fp = __double2ll_rn(step_c * kQ32);
    work.dc_r = dc_r;
    work.dc_i = dc_i;
    walk_start(sh, xs, p.n_raw, t_cur, have);
    walk(sh, xs, p.n_raw, t_cur, t_ring, work, ahead);

    const double mine = cta_tap_sum<NT>(work.acc_i, work.acc_q, ntaps, s_part);
    if (tid < 2 * ntaps) {
      for (int r = 0; r < n_rank; ++r)
        *cluster.map_shared_rank(&s_x[par][rank][tid], r) = mine;
    }
    cluster.sync();  // the one barrier of a block (two with DC removal)

    // the ranks' sums in rank order, rounded to float32 once
    auto total = [&](int j) {
      double v = 0.0;
      for (int r = 0; r < n_rank; ++r) v += s_x[par][r][j];
      return (float)v * (float)p.sign;
    };
    const long long row = (long long)step * p.n_ch + ch;
    if (rank == 0 && tid < 2 * ntaps)
      corr[row * ntaps * 2 + tid] = total(tid);

    const float e_i = total(2 * p.i_early), e_q = total(2 * p.i_early + 1);
    const float p_i = total(2 * p.i_prompt), p_q = total(2 * p.i_prompt + 1);
    const float l_i = total(2 * p.i_late), l_q = total(2 * p.i_late + 1);
    const double e = (double)sqrtf(e_i * e_i + e_q * e_q);
    const double l = (double)sqrtf(l_i * l_i + l_q * l_q);
    const double code_err = 0.5 * (e - l) / fmax(e + l, 1e-30);
    const double dll =
        dll_nco + p.dll_a * (code_err - dll_last) + code_err * p.dll_b;
    const double code_freq_new = p.code_freq_basis + p.dll_freq_sign * dll;
    const float safe_pi = p_i == 0.f ? 1e-30f : p_i;
    const double carr_err = (double)(atanf(p_q / safe_pi) / (float)kTwoPi);
    const double pll =
        pll_nco + p.pll_a * (carr_err - pll_last) + carr_err * p.pll_b;
    const double carr_freq_new = carr_basis + pll;
    const double rem_new = (double)num * step_c + rem - (double)p.n_chips;
    const unsigned phase_new = phase + (unsigned)num * carr_fp;
    const long long ptr_new = ptr + num;

    if (rank == 0 && tid == 0) {
      rec_f[0 * plane + row] = code_err;
      rec_f[1 * plane + row] = carr_err;
      rec_f[2 * plane + row] = code_freq_new;
      rec_f[3 * plane + row] = carr_freq_new;
      rec_f[4 * plane + row] = rem_new;
      rec_i[0 * plane + row] = num;
      rec_i[1 * plane + row] = ptr_new;
      rec_i[2 * plane + row] = (long long)(int)phase_new;
    }

    ptr = ptr_new; phase = phase_new; rem = rem_new;
    code_freq = code_freq_new; carr_freq = carr_freq_new;
    dll_nco = dll; dll_last = code_err;
    pll_nco = pll; pll_last = carr_err;
    num_geom = num;
  }

  // no rank leaves while a copy into its tiles is in flight or another rank
  // may still write into its slots
  cp_async_wait<0>();
  cluster.sync();

  if (rank == 0 && tid == 0) {
    double* g = state_f_out + ch * 8;
    state_i_out[ch * 2] = ptr;
    state_i_out[ch * 2 + 1] = (long long)(int)phase;
    g[0] = rem; g[1] = code_freq; g[2] = carr_freq; g[3] = carr_basis;
    g[4] = dll_nco; g[5] = dll_last; g[6] = pll_nco; g[7] = pll_last;
  }
}

template <typename RawT>
const void* kernel_of(int ntaps) {
  switch (ntaps) {
    case 3: return (const void*)track_chunk_kernel<3, RawT>;    // E/P/L
    case 25: return (const void*)track_chunk_kernel<25, RawT>;  // CT-POS grid
    default: return (const void*)track_chunk_kernel<0, RawT>;
  }
}

const void* kernel_of(int ntaps, int raw_int16) {
  return raw_int16 ? kernel_of<int16_t>(ntaps) : kernel_of<int8_t>(ntaps);
}

// The attributes a cluster launch of `func` needs; the launch configuration
// for n_ch clusters of `cluster` CTAs.
cudaError_t configure(const void* func, int n_ch, int cluster, int ntaps,
                      cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  cudaError_t rc = cudaFuncSetAttribute(
      func, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (rc != cudaSuccess) return rc;
  if (cluster > 8) {  // more than the portable maximum
    rc = cudaFuncSetAttribute(
        func, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return rc;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = cluster;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(n_ch, cluster);
  cfg->blockDim = dim3(ntaps == 3 ? threads_for(3) : threads_for(0));
  cfg->dynamicSmemBytes = kSmemBytes;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// iparams: n_ch, n_steps, ntaps, n_chips, ceil_rounding, remove_dc,
//          i_early, i_prompt, i_late, cluster (CTAs per channel, 1..16)
// fparams: fs, code_freq_basis, sign, dll_freq_sign, then tau2/tau1 and
//          dt/tau1 of the DLL and of the PLL
// Launches on `stream`, does not synchronise, returns the launch's error
// (a cluster or shared-memory size the card refuses is one).
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
  p.cluster = iparams[9];
  p.fs = fparams[0]; p.code_freq_basis = fparams[1]; p.sign = fparams[2];
  p.dll_freq_sign = fparams[3]; p.dll_a = fparams[4]; p.dll_b = fparams[5];
  p.pll_a = fparams[6]; p.pll_b = fparams[7];
  if (p.n_ch < 1 || p.ntaps < 1 || p.ntaps > kMaxTaps || p.n_steps < 0 ||
      p.cluster < 1 || p.cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const void* func = kernel_of(p.ntaps, raw_int16);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t rc = configure(func, p.n_ch, p.cluster, p.ntaps,
                             static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (rc != cudaSuccess) return (int)rc;
  void* args[] = {&p, &raw, &chips, &tap_fp, &state_i, &state_f, &corr,
                  &rec_f, &rec_i, &state_i_out, &state_f_out, &fault};
  rc = cudaLaunchKernelExC(&cfg, func, args);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs the card holds at once for the kernel
// of this tap count and sample type (cudaOccupancyMaxActiveClusters).
extern "C" int track_chunk_active_clusters(int n_ch, int cluster, int ntaps,
                                           int raw_int16, int* n_clusters) {
  const void* func = kernel_of(ntaps, raw_int16);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t rc = configure(func, n_ch, cluster, ntaps, nullptr, &cfg, &attr);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaOccupancyMaxActiveClusters(n_clusters, func, &cfg);
}

extern "C" const char* track_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
