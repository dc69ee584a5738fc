"""One-block correlator bank with the NCO state supplied from outside: the
CUDA kernel and its plain version.

`correlator_bank` correlates one coherent block of every channel: each
channel's window is read at `ptr_off` from the chunk on the device, mixed
with the int32 Q32 carrier (`phase_fp`, `carr_fp`), masked to `num`
samples, optionally freed of its mean, and every tap is correlated against
the exact Q32 chip index of the code stepping at `code_freq`.  It is what
vector tracking runs once per ms: there the code NCO is driven by the
navigation solution, so block length, code phase and code frequency come
from the caller and nothing is fed back inside
(trackingVT_POS_updated.m:164,227-232).

Two implementations of one function:

- `correlator_bank_reference` — plain PyTorch batched over channels, the
  per-block correlation of `ops/track_chunk.py` (`correlate_blocks`, the
  "nco" branch of the JAX package's `tracking.correlate_block` with `num`
  given).  The CPU tests hold it against the JAX package; on the card it is
  only the comparison for the kernel.
- the CUDA C++ kernel `csrc/corr_bank.cu` (sm_90a), built with nvcc at first
  use into `build/` and bound through a plain C entry point with ctypes.  It
  replaces the TPU kernel
  `gps_sdr_tpu/ops/pallas_track.py::correlator_bank_hbm`.  One launch moves
  about 116 KB per channel at 58 MHz, so its bound is the launch itself;
  the grid is (channel, part) so that a handful of channels still fill the
  card, each CTA staging its part through shared memory with 16-byte
  asynchronous copies, with float64 partial sums added in a fixed order (no
  floating-point atomics).

`correlator_bank_windows` is the same bank over windows the caller has
already cut out of the chunk (`WindowCutter`), one (blk, 2) window per
channel: what the per-block tracker (`tracking.track_scan`) runs for every
coherent block longer than 2 ms.  Its kernel is the second entry point of
`csrc/corr_bank.cu` and replaces the TPU kernel
`gps_sdr_tpu/ops/pallas_correlator.py::correlator_bank`; its plain version,
`correlator_bank_windows_reference`, is `correlate_blocks` with the
windows as the chunk.  Both entries share one device function and one
plain function, so on the same samples they agree bit for bit.  A 10 ms
block at 58 MHz is 1.16 MB per channel, so this entry is bound by bytes;
`default_split` gives a channel one CTA on each of its share of the SMs,
fewer where a block is too short to be worth that many set-ups.

Each wrapper takes the plain version for a tensor on the CPU and the
kernel for a CUDA tensor; there is no fallback between them.  Nothing is
clamped silently: a window that leaves the chunk, a block length outside
[1, blk] or an NCO word that is not finite raises the `fault` flag, which
`raise_on_fault` turns into an error.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gps_sdr_tpu_torch.ops import _build
from gps_sdr_tpu_torch.ops.cacode import CODE_LENGTH
from gps_sdr_tpu_torch.ops.track_chunk import (MAX_TAPS, Q32, BlockGrid,
                                               _wrap32, correlate_blocks)

SM_COUNT = 132        # H100
MIN_PART_ROWS = 24    # a part is worth its set-up from 24 rows of 128 samples


def tap_offsets_fp(taps: Sequence[float], device) -> torch.Tensor:
    """(T,) int64 Q32 tap offsets on `device`, rounded half to even like
    jnp.round.  Made once by the caller, not per block."""
    fp = np.round(np.asarray(taps, np.float64) * Q32).astype(np.int64)
    return torch.as_tensor(fp, device=device)


def new_fault(device) -> torch.Tensor:
    """A cleared fault flag: (1,) int32 on `device`."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _check_inputs(raw, words, chips, tap_fp, blk, fault) -> None:
    """`words`: the per-channel (N,) tensors by name, int64 except
    `rem_chip` and `code_freq` (float64)."""
    n = words["num"].shape[0]
    if n == 0:
        raise ValueError("no channels to correlate")
    if chips.shape != (n, CODE_LENGTH) or chips.dtype != torch.float32:
        raise ValueError(f"chips must be ({n}, {CODE_LENGTH}) float32, got "
                         f"{tuple(chips.shape)} {chips.dtype}")
    if tap_fp.dim() != 1 or not 1 <= tap_fp.shape[0] <= MAX_TAPS \
            or tap_fp.dtype != torch.int64:
        raise ValueError(f"tap_fp must be (1..{MAX_TAPS},) int64, got "
                         f"{tuple(tap_fp.shape)} {tap_fp.dtype}")
    if blk < 128 or blk % 128:
        raise ValueError(f"blk must be a positive multiple of 128, got {blk}")
    for name, t in words.items():
        dtype = (torch.float64 if name in ("rem_chip", "code_freq")
                 else torch.int64)
        if t.shape != (n,) or t.dtype != dtype or t.device != raw.device:
            raise ValueError(f"{name} must be ({n},) {dtype} on {raw.device},"
                             f" got {tuple(t.shape)} {t.dtype} on {t.device}")
    for name, t in (("chips", chips), ("tap_fp", tap_fp), ("fault", fault)):
        if t.device != raw.device:
            raise ValueError(f"{name} must be on {raw.device}")
    if fault.shape != (1,) or fault.dtype != torch.int32:
        raise ValueError("fault must be a (1,) int32 tensor")


def _check_raw(raw) -> None:
    if raw.dtype not in (torch.int8, torch.int16) or raw.dim() != 2 \
            or raw.shape[1] != 2:
        raise ValueError(f"raw must be (L, 2) int8/int16 IQ, got "
                         f"{tuple(raw.shape)} {raw.dtype}")


def raise_flag(fault: torch.Tensor, bad: torch.Tensor) -> None:
    """fault = max(fault, 1 + the last channel of `bad`), on the device."""
    ids = torch.arange(1, bad.shape[0] + 1, dtype=torch.int32,
                       device=bad.device)
    fault.copy_(torch.maximum(fault, (bad * ids).max().reshape(1)))


def correlator_bank_reference(raw: torch.Tensor, ptr_off: torch.Tensor,
                              rem_chip: torch.Tensor, code_freq: torch.Tensor,
                              phase_fp: torch.Tensor, carr_fp: torch.Tensor,
                              num: torch.Tensor, chips: torch.Tensor,
                              tap_fp: torch.Tensor, fs: float, blk: int,
                              remove_dc: bool = False,
                              fault: Optional[torch.Tensor] = None,
                              grid: Optional[BlockGrid] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: one block × all channels.

    raw        (L, 2) int8/int16 IQ of the chunk (cast here, as on the
               device)
    ptr_off    (N,) int64 window start inside the chunk
    rem_chip   (N,) float64 code phase at the window start [chips]
    code_freq  (N,) float64 code frequency the replica steps at [Hz]
    phase_fp, carr_fp  (N,) int64 Q32 carrier phase and phase step per
               sample (taken mod 2³²)
    num        (N,) int64 block length; samples k ≥ num are masked
    chips      (N, 1023) float32 ±1 codes; tap_fp from `tap_offsets_fp`
    fault      (1,) int32 flag to raise (a new one when None); no host
               synchronisation happens here
    Returns (corr (N, T, 2) float32 [I, Q], fault): fault becomes at least
    1 + the last channel whose window left the chunk, whose `num` is
    outside [1, blk] or whose NCO words are not finite.
    """
    if fault is None:
        fault = new_fault(raw.device)
    if grid is None:
        grid = BlockGrid.make(blk, raw.device)
    fs_t = torch.tensor(fs, dtype=torch.float64, device=raw.device)
    step = code_freq / fs_t
    bad = ((num < 1) | (num > blk) | (ptr_off < 0)
           | (ptr_off + num > raw.shape[0])
           | ~torch.isfinite(rem_chip) | ~torch.isfinite(step))
    raise_flag(fault, bad)
    corr = correlate_blocks(
        raw.to(torch.float32), ptr_off, num, rem_chip, step,
        _wrap32(phase_fp), _wrap32(carr_fp), chips, tap_fp, remove_dc,
        grid)
    return torch.where(bad[:, None, None], 0.0, corr), fault


class WindowCutter:
    """Cuts per-channel block windows out of one chunk on its device.

    No index tensor of the windows' size is built: each IQ pair is viewed
    as one wider integer and the chunk as all its overlapping windows (a
    strided view, made once per chunk, no memory); a cut selects the N rows
    at `off`.
    """

    def __init__(self, raw: torch.Tensor, blk: int):
        _check_raw(raw)
        if raw.shape[0] < blk or not raw.is_contiguous():
            raise ValueError(f"raw must be contiguous and hold at least one "
                             f"window of {blk} samples, got "
                             f"{tuple(raw.shape)}")
        pair = torch.int16 if raw.dtype == torch.int8 else torch.int32
        self.dtype, self.blk = raw.dtype, blk
        self.last = raw.shape[0] - blk          # the last window's offset
        self.windows = raw.view(pair).squeeze(1).unfold(0, blk, 1)

    def __call__(self, off: torch.Tensor) -> torch.Tensor:
        """(N, blk, 2) contiguous copies of raw[off[ch] : off[ch] + blk].
        Offsets are clamped into [0, L − blk]: the caller flags a window
        that leaves the chunk."""
        win = self.windows.index_select(0, off.clamp(0, self.last))
        return win.view(self.dtype).view(off.shape[0], self.blk, 2)


def cut_windows(raw: torch.Tensor, off: torch.Tensor, blk: int
                ) -> torch.Tensor:
    """One cut of `WindowCutter(raw, blk)` at `off`."""
    return WindowCutter(raw, blk)(off)


def correlator_bank_windows_reference(
        win: torch.Tensor, rem_chip: torch.Tensor, code_freq: torch.Tensor,
        phase_fp: torch.Tensor, carr_fp: torch.Tensor, num: torch.Tensor,
        chips: torch.Tensor, tap_fp: torch.Tensor, fs: float,
        remove_dc: bool = False, fault: Optional[torch.Tensor] = None,
        grid: Optional[BlockGrid] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `correlator_bank_windows`: the per-block
    correlation of `correlator_bank_reference` with the windows laid end to
    end as the chunk.

    win        (N, blk, 2) int8/int16 IQ, channel ch's block in win[ch]
    The other arguments and the result as `correlator_bank_reference`;
    fault is raised for a `num` outside [1, blk] or NCO words that are not
    finite (a window cannot leave its chunk here).
    """
    n, blk = win.shape[0], win.shape[1]
    if fault is None:
        fault = new_fault(win.device)
    if grid is None:
        grid = BlockGrid.make(blk, win.device)
    step = code_freq / torch.tensor(fs, dtype=torch.float64,
                                    device=win.device)
    bad = ((num < 1) | (num > blk) | ~torch.isfinite(rem_chip)
           | ~torch.isfinite(step))
    raise_flag(fault, bad)
    off = torch.arange(n, dtype=torch.int64, device=win.device) * blk
    corr = correlate_blocks(
        win.reshape(n * blk, 2).to(torch.float32), off, num, rem_chip, step,
        _wrap32(phase_fp), _wrap32(carr_fp), chips, tap_fp, remove_dc,
        grid)
    return torch.where(bad[:, None, None], 0.0, corr), fault


# ---------------------------------------------------------------- build


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    path, _, _ = _build.build_library("corr_bank")
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.corr_bank_launch.argtypes = [
        p, i, ctypes.c_longlong,              # raw, int16?, n_raw
        p, p, p, p, p, p, p, p,               # chips, tap_fp, 6 per-channel
        p, p, p,                              # corr, partial, fault
        i, i, i, i, i, ctypes.c_double, p]    # n_ch … remove_dc, fs, stream
    lib.corr_bank_launch.restype = i
    lib.corr_bank_windows_launch.argtypes = [
        p, i,                                 # win, int16?
        p, p, p, p, p, p, p,                  # chips, tap_fp, 5 per-channel
        p, p, p,                              # corr, partial, fault
        i, i, i, i, i, ctypes.c_double, p]    # n_ch … remove_dc, fs, stream
    lib.corr_bank_windows_launch.restype = i
    lib.corr_bank_empty_launch.argtypes = [p]
    lib.corr_bank_empty_launch.restype = i
    lib.corr_bank_error_string.argtypes = [i]
    lib.corr_bank_error_string.restype = ctypes.c_char_p
    return lib


def default_split(n_ch: int, blk: int) -> int:
    """CTAs per channel for a block window of `blk` samples: one wave with
    one CTA an SM (every CTA makes the channel's code and phasor tables, so
    a second CTA on an SM costs more set-up than its warps hide, and a wave
    that does not fill evenly waits for its fullest SM), cut down for a
    short block until a part is `MIN_PART_ROWS` rows long (below that the
    launch, the set-up and the second kernel are the floor, and more parts
    only add to them).  Both limits are what measured best on the card at 1
    and 10 ms, 3 and 25 taps, DC removal on and off."""
    return max(1, min(SM_COUNT // n_ch, blk // 128 // MIN_PART_ROWS))


def part_share(num: int, n_split: int, part: int) -> Tuple[int, int]:
    """Samples [lo, hi) of a block of `num` that part `part` of `n_split`
    correlates: whole 128-sample rows, the kernel's rule (`part_share` in
    csrc/corr_bank.cu), kept here for the tests that hold it."""
    rows = (num + 127) >> 7
    rows_per = -(-rows // n_split)
    lo = part * rows_per * 128
    return min(num, lo), min(num, lo + rows_per * 128)


def _launch(wrapper, raw, ptr_off, rem_chip, code_freq, phase_fp, carr_fp,
            num, chips, tap_fp, fs, blk, remove_dc, fault, n_split):
    """Launch the fetching entry (`ptr_off` given) or the windows entry
    (`ptr_off` None, `raw` the windows) and count it on `wrapper`."""
    dev = raw.device
    if not (raw.is_contiguous() and chips.is_contiguous()):
        raise ValueError("the samples and chips must be contiguous")
    # the (N,) words may be views (a column of a packed state): no copy
    # when they are contiguous already
    tap_fp, rem_chip, code_freq, phase_fp, carr_fp, num = (
        t.contiguous() for t in (tap_fp, rem_chip, code_freq, phase_fp,
                                 carr_fp, num))
    lib = load_library()
    n, ntaps = num.shape[0], tap_fp.shape[0]
    if n_split is None:
        n_split = default_split(n, blk)
    corr = torch.empty((n, ntaps, 2), dtype=torch.float32, device=dev)
    # per part: the tap sums, then its integer sums for DC removal
    partial = torch.empty((n, n_split, ntaps + 1, 2), dtype=torch.float64,
                          device=dev)
    words = (rem_chip.data_ptr(), code_freq.data_ptr(), phase_fp.data_ptr(),
             carr_fp.data_ptr(), num.data_ptr(), corr.data_ptr(),
             partial.data_ptr(), fault.data_ptr(), n, ntaps, int(n_split),
             int(blk), int(remove_dc), float(fs))
    is16 = int(raw.dtype == torch.int16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if ptr_off is None:
            rc = lib.corr_bank_windows_launch(
                raw.data_ptr(), is16, chips.data_ptr(), tap_fp.data_ptr(),
                *words, stream)
        else:
            ptr_off = ptr_off.contiguous()
            rc = lib.corr_bank_launch(
                raw.data_ptr(), is16, raw.shape[0], chips.data_ptr(),
                tap_fp.data_ptr(), ptr_off.data_ptr(), *words, stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__}: kernel launch failed: "
                           + lib.corr_bank_error_string(rc).decode())
    wrapper.launches += 1
    return corr, fault


def correlator_bank(raw: torch.Tensor, ptr_off: torch.Tensor,
                    rem_chip: torch.Tensor, code_freq: torch.Tensor,
                    phase_fp: torch.Tensor, carr_fp: torch.Tensor,
                    num: torch.Tensor, chips: torch.Tensor,
                    tap_fp: torch.Tensor, fs: float, blk: int,
                    remove_dc: bool = False,
                    fault: Optional[torch.Tensor] = None,
                    grid: Optional[BlockGrid] = None,
                    n_split: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Correlate one block of all channels from the given NCO state.

    Arguments and result as `correlator_bank_reference`.  A CPU `raw` runs
    the plain version (`grid` saves it rebuilding its index tensors); a
    CUDA `raw` launches the kernel (`n_split` CTAs per channel, default
    `default_split`) or raises.  Neither synchronises with the host: read
    `fault` back with `raise_on_fault` when the results are.
    """
    if fault is None:
        fault = new_fault(raw.device)
    _check_raw(raw)
    _check_inputs(raw, dict(ptr_off=ptr_off, num=num, phase_fp=phase_fp,
                            carr_fp=carr_fp, rem_chip=rem_chip,
                            code_freq=code_freq), chips, tap_fp, blk, fault)
    if raw.device.type == "cpu":
        return correlator_bank_reference(
            raw, ptr_off, rem_chip, code_freq, phase_fp, carr_fp, num, chips,
            tap_fp, fs, blk, remove_dc, fault, grid)
    if raw.device.type != "cuda":
        raise ValueError(f"correlator_bank: no kernel for {raw.device}")
    return _launch(correlator_bank, raw, ptr_off, rem_chip, code_freq,
                   phase_fp, carr_fp, num, chips, tap_fp, fs, blk, remove_dc,
                   fault, n_split)


correlator_bank.launches = 0   # kernel launches (the CUDA path only)


def correlator_bank_windows(
        win: torch.Tensor, rem_chip: torch.Tensor, code_freq: torch.Tensor,
        phase_fp: torch.Tensor, carr_fp: torch.Tensor, num: torch.Tensor,
        chips: torch.Tensor, tap_fp: torch.Tensor, fs: float,
        remove_dc: bool = False, fault: Optional[torch.Tensor] = None,
        grid: Optional[BlockGrid] = None, n_split: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Correlate one block of all channels over windows already cut out.

    Arguments and result as `correlator_bank_windows_reference`.  A CPU
    `win` runs the plain version; a CUDA `win` launches the kernel or
    raises.  Neither synchronises with the host.
    """
    if fault is None:
        fault = new_fault(win.device)
    if win.dtype not in (torch.int8, torch.int16) or win.dim() != 3 \
            or win.shape[2] != 2:
        raise ValueError(f"win must be (N, blk, 2) int8/int16 IQ, got "
                         f"{tuple(win.shape)} {win.dtype}")
    blk = win.shape[1]
    _check_inputs(win, dict(num=num, phase_fp=phase_fp, carr_fp=carr_fp,
                            rem_chip=rem_chip, code_freq=code_freq), chips,
                  tap_fp, blk, fault)
    if win.shape[0] != num.shape[0]:
        raise ValueError(f"win holds {win.shape[0]} windows for "
                         f"{num.shape[0]} channels")
    if win.device.type == "cpu":
        return correlator_bank_windows_reference(
            win, rem_chip, code_freq, phase_fp, carr_fp, num, chips, tap_fp,
            fs, remove_dc, fault, grid)
    if win.device.type != "cuda":
        raise ValueError(f"correlator_bank_windows: no kernel for "
                         f"{win.device}")
    return _launch(correlator_bank_windows, win, None, rem_chip, code_freq,
                   phase_fp, carr_fp, num, chips, tap_fp, fs, blk, remove_dc,
                   fault, n_split)


correlator_bank_windows.launches = 0   # kernel launches (CUDA path only)


def empty_launch(device) -> None:
    """Launch a kernel that does nothing on `device`'s current stream: the
    launch floor this bank is measured against."""
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.corr_bank_empty_launch(
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError("empty launch failed: "
                           + lib.corr_bank_error_string(rc).decode())


def raise_on_fault(fault: torch.Tensor) -> None:
    """Raise if a block was refused (see `correlator_bank`).  Reads the
    flag back: one host synchronisation."""
    ch = int(fault[0])
    if ch:
        raise RuntimeError(
            f"correlator_bank: channel {ch - 1}'s block window left the "
            "chunk, its length is outside [1, blk], or its NCO state is "
            "not finite (tracking diverged or chunk too short)")
