// What the receiver's correlator kernels share: the Q32 carrier phasors, the
// exact Q32 chip index, the mix of one IQ sample and the warp reduction.
//
// Every function here evaluates the float32 operations of the plain PyTorch
// versions (ops/track_chunk.py, ops/corr_bank.py) in the same order.  The
// kernels are built with -fmad=false, so nothing below contracts a*b+c and
// the kernels round where the plain versions round.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nco {

constexpr int kCodeLen = 1023;
constexpr int kMaxTaps = 32;
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

// Chip of sample k for one tap: ((base + tap + k*step - 1) >> 32) mod 1023
// with kb = base + k*step - 1 (tracking.py:305-312); the shift is arithmetic,
// so negative indices floor.
__device__ __forceinline__ int chip_index(long long kb, long long tap_fp) {
  int ci = (int)((kb + tap_fp) >> 32) % kCodeLen;
  ci += ci < 0 ? kCodeLen : 0;
  return ci;
}

}  // namespace nco
