"""Whole-chunk DLL/PLL tracking: the CUDA kernel and its plain version.

`track_chunk` runs every coherent block of one chunk for all channels: per
block the code NCO sets the block length (round or ceil), the int32 Q32
carrier phase mixes the IQ (optional DC removal), each tap correlates
against the exact Q32 chip index of the code, and the E−L envelope DLL and
the atan(Q/I) Costas PLL close both 2nd-order loops and feed the NCOs
(trackingCT.m:96-150; trackingCT_POS_updated.m:210-270 for the POS
variants).

Two implementations of one function:

- `track_chunk_reference` — plain PyTorch, a Python loop over blocks
  batched over channels: exactly the "nco" block of the JAX package's
  `tracking.correlate_block` plus its `scan_step`.  The CPU tests hold it
  against the JAX scan; on the card it is only the comparison for the
  kernel.
- the CUDA C++ kernel `csrc/track_chunk.cu` (sm_90a), built with nvcc at
  first use into `build/` and bound through a plain C entry point with
  ctypes.  It replaces the TPU kernel
  `gps_sdr_tpu/ops/pallas_track.py::fused_track_chunk`: a thread-block
  cluster per channel loops over every block of the chunk in one launch.
  Each rank of the cluster correlates a contiguous share of the block from
  tiles staged in shared memory by 16-byte asynchronous copies (the next
  block's first tile while this block is correlated), the ranks exchange
  their float64 tap sums through distributed shared memory at one cluster
  barrier per block, and every rank closes both loops itself.  Blocks of a
  channel are serial, so it is bound by the instruction rate and the
  latencies of one block, not by bytes or FLOPs.

Both evaluate the same float32 operations in the same order (the Q32
phasor-product carrier of the JAX scan, float64 correlator sums of exact
±1·sample products, true divisions, no fused multiply-add), so on the
card they agree to the float32 rounding of a float64 sum, whatever the
order the samples are summed in.  That matters
because the loops round float64 NCO words to integers (carr_fp, the block
length) every block: one flipped rounding sends two otherwise equal loops
down different, equally valid, noise trajectories.

`track_chunk` takes the plain version for a tensor on the CPU and the
kernel for a CUDA tensor; there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gps_sdr_tpu_torch.ops import _build
from gps_sdr_tpu_torch.ops.cacode import CODE_LENGTH
from gps_sdr_tpu_torch.ops.loops import (dll_discriminator, loop_filter_step,
                                         pll_discriminator)

Q32 = 4294967296.0  # 2**32
MAX_TAPS = 32
MAX_CLUSTER = 8     # CTAs per channel at most (the portable cluster size)

_STATE_I = ("ptr", "phase_fp")
_STATE_F = ("rem_chip", "code_freq", "carr_freq", "carr_freq_basis",
            "dll_nco", "dll_last", "pll_nco", "pll_last")


class ChunkSpec(NamedTuple):
    """Static configuration of one tracking segment, as the kernel takes it."""

    taps: Tuple[float, ...]        # correlator offsets [chips]
    epl: Tuple[int, int, int]      # early / prompt / late tap indices
    pdi_ms: int                    # coherent block [ms]; n_chips = 1023·pdi
    ceil_rounding: bool            # block length: ceil (POS) or round
    sign: float                    # −1 negates the correlators
    remove_dc: bool
    dll_freq_sign: float           # codeFreq = basis + sign·nco
    tau_c: Tuple[float, float]     # DLL (tau1, tau2)
    tau_r: Tuple[float, float]     # PLL (tau1, tau2)
    dt: float                      # loop update interval [s]
    fs: float
    code_freq_basis: float

    @property
    def n_chips(self) -> int:
        return CODE_LENGTH * self.pdi_ms

    @property
    def samples_per_ms(self) -> int:
        return int(math.ceil(self.fs * 1e-3))

    @property
    def blk(self) -> int:
        """The JAX scan's fixed block window (tracking.py:548): pdi·S + 256
        rounded up to 128 samples."""
        return -(-(self.samples_per_ms * self.pdi_ms + 256) // 128) * 128

    def chunk_samples(self, n_steps: int) -> int:
        """Samples a chunk must hold past its furthest channel pointer:
        n_steps nominal blocks plus one block window and 64 samples of
        slack for the code-Doppler drift (tracking.py:629)."""
        return n_steps * self.pdi_ms * self.samples_per_ms + self.blk + 64

    def loop_gains(self) -> Tuple[float, float, float, float]:
        """(tau2/tau1, dt/tau1) of the DLL, then of the PLL:
        nco' = nco + (tau2/tau1)·(e − e_prev) + e·(dt/tau1)."""
        (t1c, t2c), (t1r, t2r) = self.tau_c, self.tau_r
        return t2c / t1c, self.dt / t1c, t2r / t1r, self.dt / t1r

    def tap_fp(self) -> np.ndarray:
        """Q32 tap offsets, rounded half to even like jnp.round."""
        return np.round(np.asarray(self.taps, np.float64) * Q32
                        ).astype(np.int64)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value congruent mod 2³² (kept in int64)."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def _records(corr, code_err, carr_err, code_freq, carr_freq, num, rem_chip,
             phase, abs_sample, fault) -> Dict[str, torch.Tensor]:
    return dict(
        corr=corr, code_err=code_err, carr_err=carr_err,
        code_freq=code_freq, carr_freq=carr_freq, num_sample=num,
        rem_chip=rem_chip,
        rem_phase=torch.remainder(
            phase.to(torch.float64) * (2.0 * math.pi / Q32), 2.0 * math.pi),
        absolute_sample=abs_sample, fault=fault)


def check_inputs(raw: torch.Tensor, state, chips: torch.Tensor,
                 spec: ChunkSpec, n_steps: int, chunk_start: int) -> None:
    """Raise unless `raw`, `state` and `chips` are what a tracker of one
    chunk takes and the chunk covers `n_steps` blocks of every channel."""
    if raw.dtype not in (torch.int8, torch.int16) or raw.dim() != 2 \
            or raw.shape[1] != 2:
        raise ValueError(f"raw must be (L, 2) int8/int16 IQ, got "
                         f"{tuple(raw.shape)} {raw.dtype}")
    n = state.ptr.shape[0]
    if n == 0:
        raise ValueError("no channels to track")
    if chips.shape != (n, CODE_LENGTH) or chips.dtype != torch.float32:
        raise ValueError(f"chips must be ({n}, {CODE_LENGTH}) float32, got "
                         f"{tuple(chips.shape)} {chips.dtype}")
    if not 1 <= len(spec.taps) <= MAX_TAPS:
        raise ValueError(f"1..{MAX_TAPS} taps supported, got "
                         f"{len(spec.taps)}")
    if spec.pdi_ms < 1 or n_steps < 0:
        raise ValueError(f"bad pdi_ms={spec.pdi_ms} / n_steps={n_steps}")
    for f in _STATE_I + _STATE_F:
        t = getattr(state, f)
        if t.device != raw.device or t.shape != (n,):
            raise ValueError(f"state.{f} must be ({n},) on {raw.device}")
    offs = state.ptr - int(chunk_start)
    lo, hi = int(offs.min()), int(offs.max())
    need = hi + spec.chunk_samples(n_steps)
    if lo < 0 or raw.shape[0] < need:
        raise ValueError(
            f"chunk of {raw.shape[0]} samples does not cover the channels' "
            f"windows: pointer offsets [{lo}, {hi}] + {n_steps} blocks "
            f"need {need}")


class BlockGrid(NamedTuple):
    """Index tensors of one block window of `blk` = 128·nq samples."""

    k: torch.Tensor        # (blk,) int64 sample index
    q: torch.Tensor        # (nq,) int64 row index, k = 128·q + r
    r: torch.Tensor        # (128,) int64
    to_rad: torch.Tensor   # float32 scalar: one Q32 LSB in radians

    @staticmethod
    def make(blk: int, device) -> "BlockGrid":
        i64 = torch.int64
        return BlockGrid(
            k=torch.arange(blk, dtype=i64, device=device),
            q=torch.arange(blk // 128, dtype=i64, device=device),
            r=torch.arange(128, dtype=i64, device=device),
            to_rad=torch.tensor(2.0 * math.pi / Q32, dtype=torch.float32,
                                device=device))


def correlate_blocks(x_all: torch.Tensor, off: torch.Tensor,
                     num: torch.Tensor, rem: torch.Tensor,
                     step: torch.Tensor, phase: torch.Tensor,
                     carr_fp: torch.Tensor, chips: torch.Tensor,
                     tap_fp: torch.Tensor, remove_dc: bool,
                     grid: BlockGrid) -> torch.Tensor:
    """One coherent block of every channel, plain PyTorch: the "nco" branch
    of the JAX package's `tracking.correlate_block` batched over channels.

    x_all (L, 2) chunk, float32 or the raw int8/int16 pairs (each window is
    cast after it is cut, exactly: a whole-capture buffer is never cast as a
    whole); per channel (N,): `off` window start in the
    chunk and `num` block length (int64), `rem` code phase [chips] and
    `step` chips per sample (float64), `phase` and `carr_fp` Q32 carrier
    words (int64 holding int32 values); chips (N, 1023) float32; tap_fp
    (T,) int64 Q32 tap offsets.  Window indices are clamped into the chunk
    (the caller flags a window that leaves it).  Returns (N, T, 2) float32
    [I, Q] sums.
    """
    f32, f64 = torch.float32, torch.float64
    n = off.shape[0]
    blk = grid.k.shape[0]
    idx = torch.clamp(off[:, None] + grid.k[None, :], 0, x_all.shape[0] - 1)
    mask = (grid.k[None, :] < num[:, None])[..., None]
    x = torch.where(mask, x_all[idx].to(f32), 0.0)             # (N, blk, 2)
    if remove_dc:
        # integer sums are exact in float64: the mean is order-free
        dc = (x.sum(dim=1, dtype=f64) / num.to(f64)[:, None]).to(f32)
        x = torch.where(mask, x - dc[:, None, :], 0.0)

    # ---- carrier: Q32 phasor outer product (tracking.py:274-288) ----
    phq = _wrap32(phase[:, None] + grid.q[None, :] * (carr_fp[:, None] * 128)
                  ).to(f32) * grid.to_rad
    phr = _wrap32(grid.r[None, :] * carr_fp[:, None]).to(f32) * grid.to_rad
    uc, us = torch.cos(phq), torch.sin(phq)
    vc, vs = torch.cos(phr), torch.sin(phr)
    c = (uc[:, :, None] * vc[:, None, :]
         - us[:, :, None] * vs[:, None, :]).reshape(n, blk)
    s = (uc[:, :, None] * vs[:, None, :]
         + us[:, :, None] * vc[:, None, :]).reshape(n, blk)
    xr, xi = x[..., 0], x[..., 1]
    # mixed = x·e^{iθ}: I = imag, Q = real (trackingCT.m:113)
    iq = torch.stack([xr * s + xi * c, xr * c - xi * s], dim=-1)

    # ---- exact Q32 chip index per tap (tracking.py:305-312) ----
    step_fp = torch.round(step * Q32).to(torch.int64)
    base_fp = torch.round(rem * Q32).to(torch.int64)
    # arithmetic shift: floor division by 2^32, negative indices too
    cidx = torch.bitwise_right_shift(
        (base_fp[:, None] + tap_fp[None, :] - 1)[:, :, None]
        + grid.k[None, None, :] * step_fp[:, None, None], 32)
    cidx = torch.remainder(cidx, CODE_LENGTH)                  # (N, T, blk)
    code = torch.gather(chips, 1, cidx.reshape(n, -1)).reshape(cidx.shape)
    # float64 sums of the exact ±1·sample products, rounded once
    return torch.einsum("ntb,nbc->ntc", code.to(f64), iq.to(f64)).to(f32)


class BlockNCO(NamedTuple):
    """What a bank is given for one block: (N,) tensors per channel."""

    ptr: torch.Tensor        # int64 absolute sample of the block's start
    num: torch.Tensor        # int64 block length
    n_exact: torch.Tensor    # float64 block length before rounding
    rem_chip: torch.Tensor   # float64 code phase at the start [chips]
    code_freq: torch.Tensor  # float64 [Hz]
    step: torch.Tensor       # float64 chips per sample, code_freq / fs
    phase: torch.Tensor      # int64 holding the int32 Q32 carrier phase
    carr_fp: torch.Tensor    # int64 holding the int32 Q32 phase step


class LoopConsts(NamedTuple):
    """Per-segment constants of `block_step` on one device."""

    fs: torch.Tensor         # float64 scalar
    sign: torch.Tensor       # float32 scalar
    gains: Tuple[float, float, float, float]

    @staticmethod
    def make(spec: ChunkSpec, device) -> "LoopConsts":
        # divisors as device tensors: a true division on every device (CUDA
        # turns division by a host scalar into a reciprocal multiply)
        return LoopConsts(
            fs=torch.tensor(spec.fs, dtype=torch.float64, device=device),
            sign=torch.tensor(spec.sign, dtype=torch.float32, device=device),
            gains=spec.loop_gains())


def block_step(st, spec: ChunkSpec, k: LoopConsts, bank):
    """One coherent block of every channel: block length and carrier word
    from the NCOs, the correlators from `bank(BlockNCO) → (N, T, 2)`, then
    the NCO advance, the discriminators and both loop filters.

    `st` is the TrackState-like carry with `phase_fp` held in int64.  The
    one arithmetic of both trackers: `track_chunk_reference` gives it the
    bank that reads the chunk, `tracking.track_scan` the bank over windows.
    Returns (new carry, record row, the BlockNCO the bank was given).
    """
    f64, i64 = torch.float64, torch.int64
    n_chips = spec.n_chips
    ie, ip, il = spec.epl
    dll_a, dll_b, pll_a, pll_b = k.gains
    # ---- block length from the code NCO (tracking.py:252-256) ----
    step = st.code_freq / k.fs
    n_exact = (n_chips - st.rem_chip) / step
    num = (torch.ceil(n_exact) if spec.ceil_rounding
           else torch.round(n_exact)).to(i64)
    carr_fp = _wrap32(torch.round(st.carr_freq / k.fs * Q32).to(i64))
    nco = BlockNCO(st.ptr, num, n_exact, st.rem_chip, st.code_freq, step,
                   st.phase_fp, carr_fp)
    corr = bank(nco) * k.sign

    rem = num.to(f64) * step + st.rem_chip - n_chips
    phase = _wrap32(st.phase_fp + num * carr_fp)

    # ---- discriminators + 2nd-order loop filters (tracking.py:410-430)
    code_err = dll_discriminator(corr[:, ie, 0], corr[:, ie, 1],
                                 corr[:, il, 0], corr[:, il, 1])
    dll = loop_filter_step(st.dll_nco, st.dll_last, code_err, dll_a, dll_b)
    code_freq = spec.code_freq_basis + spec.dll_freq_sign * dll
    carr_err = pll_discriminator(corr[:, ip, 0], corr[:, ip, 1])
    pll = loop_filter_step(st.pll_nco, st.pll_last, carr_err, pll_a, pll_b)
    carr_freq = st.carr_freq_basis + pll

    ptr = st.ptr + num
    new = st._replace(ptr=ptr, rem_chip=rem, code_freq=code_freq,
                      carr_freq=carr_freq, phase_fp=phase, dll_nco=dll,
                      dll_last=code_err, pll_nco=pll, pll_last=carr_err)
    row = (corr, code_err, carr_err, code_freq, carr_freq, num, rem, phase,
           ptr)
    return new, row, nco


def stack_rows(rows, fault: torch.Tensor, n: int, ntaps: int
               ) -> Dict[str, torch.Tensor]:
    """The record dict from the rows of `block_step`, (T, N, …) per field."""
    dev = fault.device
    f32, f64, i64 = torch.float32, torch.float64, torch.int64
    if rows:
        cols = [torch.stack(c) for c in zip(*rows)]
    else:
        cols = [torch.zeros((0, n, ntaps, 2), dtype=f32, device=dev)] + [
            torch.zeros((0, n), dtype=dt, device=dev)
            for dt in (f64, f64, f64, f64, i64, f64, i64, i64)]
    return _records(*cols, fault)


def track_chunk_reference(raw: torch.Tensor, chunk_start: int, state,
                          chips: torch.Tensor, spec: ChunkSpec,
                          n_steps: int):
    """Plain PyTorch version: `n_steps` blocks × all channels.

    raw         (L, 2) int8/int16 IQ of the chunk (each block window cast
                here, as on the device) or of the whole capture;
                chunk_start the absolute sample of raw[0]
    state       TrackState-like NamedTuple of (N,) tensors
    chips       (N, 1023) float32 ±1 codes
    Returns (records, new_state): records are (T, N, …) tensors with the
    JAX dtypes (corr float32, num_sample/absolute_sample int64, the rest
    float64) plus `fault`, a (1,) int32 that is 1 + the first channel
    whose block window left the chunk (0 when none did).
    """
    dev = raw.device
    L = raw.shape[0]
    n = state.ptr.shape[0]
    tap_fp = torch.as_tensor(spec.tap_fp(), device=dev)
    grid = BlockGrid.make(spec.blk, dev)
    k = LoopConsts.make(spec, dev)

    def bank(b: BlockNCO) -> torch.Tensor:
        return correlate_blocks(raw, b.ptr - chunk_start, b.num,
                                b.rem_chip, b.step, b.phase, b.carr_fp,
                                chips, tap_fp, spec.remove_dc, grid)

    st = state._replace(phase_fp=state.phase_fp.to(torch.int64))
    rows = []                        # per block: the record fields
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(n_steps):
        st, row, b = block_step(st, spec, k, bank)
        off = b.ptr - chunk_start
        bad |= (off < 0) | (off + b.num > L) | ~torch.isfinite(b.n_exact)
        rows.append(row)

    first = torch.nonzero(bad)
    fault = torch.zeros(1, dtype=torch.int32, device=dev)
    if first.numel():
        fault[0] = int(first[0, 0]) + 1
    new_state = st._replace(phase_fp=st.phase_fp.to(torch.int32))
    return stack_rows(rows, fault, n, len(spec.taps)), new_state


# ---------------------------------------------------------------- build


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    path, _, _ = _build.build_library("track_chunk")
    lib = ctypes.CDLL(str(path))
    p = ctypes.c_void_p
    lib.track_chunk_launch.argtypes = [
        p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,   # raw
        p, p, p, p,                           # chips, tap_fp, state_i/f
        p, p, p, p, p, p,                     # corr, rec_f/i, state out, fault
        p, p, p]                              # iparams, fparams, stream
    lib.track_chunk_launch.restype = ctypes.c_int
    lib.track_chunk_active_clusters.argtypes = [ctypes.c_int] * 4 + [p]
    lib.track_chunk_active_clusters.restype = ctypes.c_int
    lib.track_chunk_error_string.argtypes = [ctypes.c_int]
    lib.track_chunk_error_string.restype = ctypes.c_char_p
    return lib


def cluster_size(n_ch: int, sm_count: int) -> int:
    """CTAs per channel: the largest power of two, at most `MAX_CLUSTER`,
    with which every channel's cluster finds SMs of its own (clusters that
    do not only queue: channels are independent)."""
    c = 1
    while 2 * c <= MAX_CLUSTER and n_ch * 2 * c <= sm_count:
        c *= 2
    return c


def rank_share(num: int, num_geom: int, rank: int, n_rank: int
               ) -> Tuple[int, int]:
    """Samples [lo, hi) of a block of `num` that rank `rank` of a cluster of
    `n_rank` correlates when the shares were laid out for a block of
    `num_geom` samples (the block before: its length is what is known when
    the next block's first tiles are staged).  Ranks but the last take whole
    128-sample rows, the last what remains.  The kernel's rule (`rank_share`
    in csrc/track_chunk.cu), kept here for the tests that hold it."""
    rows_per = -(-((num_geom + 127) >> 7) // n_rank)
    w = rows_per * 128
    lo = min(num, rank * w)
    hi = num if rank == n_rank - 1 else min(num, (rank + 1) * w)
    return lo, hi


def tile_origin(byte_addr: int, pair_bytes: int) -> int:
    """Pairs between a 16-byte boundary and the pair at `byte_addr`: a tile
    starts that many pairs before its share's first sample (`align_down16`
    in csrc/nco_common.cuh)."""
    return (byte_addr & 15) // pair_bytes


def _track_chunk_cuda(raw: torch.Tensor, chunk_start: int, state,
                      chips: torch.Tensor, spec: ChunkSpec, n_steps: int,
                      cluster: Optional[int] = None):
    """`cluster`: CTAs per channel, `cluster_size` when None (the comparison
    of cluster sizes on the card gives it)."""
    dev = raw.device
    if not (raw.is_contiguous() and chips.is_contiguous()):
        raise ValueError("raw and chips must be contiguous")
    lib = load_library()
    n = state.ptr.shape[0]
    ntaps = len(spec.taps)
    state_i = torch.stack([state.ptr.to(torch.int64),
                           state.phase_fp.to(torch.int64)], 1).contiguous()
    state_f = torch.stack([getattr(state, f).to(torch.float64)
                           for f in _STATE_F], 1).contiguous()
    tap_fp = torch.as_tensor(spec.tap_fp(), device=dev)
    corr = torch.empty((n_steps, n, ntaps, 2), dtype=torch.float32,
                       device=dev)
    rec_f = torch.empty((5, n_steps, n), dtype=torch.float64, device=dev)
    rec_i = torch.empty((3, n_steps, n), dtype=torch.int64, device=dev)
    state_i_out = torch.empty_like(state_i)
    state_f_out = torch.empty_like(state_f)
    fault = torch.zeros(1, dtype=torch.int32, device=dev)
    ie, ip, il = spec.epl
    if cluster is None:
        cluster = cluster_size(
            n, torch.cuda.get_device_properties(dev).multi_processor_count)
    iparams = np.array([n, n_steps, ntaps, spec.n_chips,
                        int(spec.ceil_rounding), int(spec.remove_dc),
                        ie, ip, il, int(cluster)], np.int32)
    fparams = np.array([spec.fs, spec.code_freq_basis, spec.sign,
                        spec.dll_freq_sign, *spec.loop_gains()], np.float64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.track_chunk_launch(
            raw.data_ptr(), int(raw.dtype == torch.int16), raw.shape[0],
            int(chunk_start), chips.data_ptr(), tap_fp.data_ptr(),
            state_i.data_ptr(), state_f.data_ptr(), corr.data_ptr(),
            rec_f.data_ptr(), rec_i.data_ptr(), state_i_out.data_ptr(),
            state_f_out.data_ptr(), fault.data_ptr(),
            iparams.ctypes.data, fparams.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError("track_chunk: kernel launch failed: "
                           + lib.track_chunk_error_string(rc).decode())
    track_chunk.launches += 1
    out_f = {f: state_f_out[:, j] for j, f in enumerate(_STATE_F)}
    new_state = type(state)(
        ptr=state_i_out[:, 0], phase_fp=state_i_out[:, 1].to(torch.int32),
        **out_f)
    return _records(corr, rec_f[0], rec_f[1], rec_f[2], rec_f[3], rec_i[0],
                    rec_f[4], rec_i[2], rec_i[1], fault), new_state


def track_chunk(raw: torch.Tensor, chunk_start: int, state,
                chips: torch.Tensor, spec: ChunkSpec, n_steps: int):
    """Track all channels for `n_steps` blocks of one chunk.

    Arguments and result as `track_chunk_reference`.  A CPU `raw` runs the
    plain version; a CUDA `raw` launches the kernel (one launch) or raises.
    The chunk must hold `spec.chunk_samples(n_steps)` samples past the
    furthest channel pointer; a block window that still leaves it (a
    diverged loop) sets `records["fault"]`, which `raise_on_fault` turns
    into an error when the records are read back.
    """
    check_inputs(raw, state, chips, spec, n_steps, chunk_start)
    if raw.device.type == "cpu":
        return track_chunk_reference(raw, chunk_start, state, chips, spec,
                                     n_steps)
    if raw.device.type != "cuda":
        raise ValueError(f"track_chunk: no kernel for {raw.device}")
    return _track_chunk_cuda(raw, chunk_start, state, chips, spec, n_steps)


track_chunk.launches = 0   # kernel launches (the CUDA path only)


def active_clusters(n_ch: int, cluster: int, ntaps: int, int16: bool,
                    device) -> int:
    """How many clusters of `cluster` CTAs the card holds at once for the
    kernel of this tap count and sample type."""
    lib = load_library()
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.track_chunk_active_clusters(n_ch, cluster, ntaps, int(int16),
                                             ctypes.byref(out))
    if rc != 0:
        raise RuntimeError("track_chunk: occupancy query failed: "
                           + lib.track_chunk_error_string(rc).decode())
    return out.value


def raise_on_fault(records: Dict[str, torch.Tensor]) -> None:
    """Raise if a block's window left its chunk (see `track_chunk`)."""
    ch = int(records["fault"][0])
    if ch:
        raise RuntimeError(f"tracking: channel {ch - 1}'s block window left "
                           "the chunk or its block length left the window "
                           "(loop diverged or chunk too short)")
