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
  about 116 KB per channel at 58 MHz, so its bound is the launch itself, and
  the design is about what a launch costs the card and the host.  One
  kernel launch gives the result: the grid is (channel, part), each CTA
  stages its part through shared memory with 16-byte asynchronous copies
  and writes its float64 tap sums into its own slot, and the part of a
  channel that arrives last (an integer ticket per channel) adds the slots
  in part order: no second kernel and no floating-point atomics, so results
  repeat run to run.  The channel's code table as float64, padded and
  wrapped, and the tap words are made once (`bank_tables`), not by every CTA
  of every launch; a CTA copies them in with its first tile.  `BankPlan` is
  the prepared launch: made once per chunk from what does not change from
  block to block, it checks its inputs once, owns the result and scratch
  buffers and the argument block of the C entry point, and a call passes
  only the six per-block words.  A thread-block cluster per channel, its
  ranks' sums added through distributed shared memory, gave the same bits
  and was slower (PERF.md); `kernel_ablation.py` builds it again as a
  variant.

`correlator_bank_windows` is the same bank over windows the caller has
already cut out of the chunk (`WindowCutter`), one (blk, 2) window per
channel: what the per-block tracker (`tracking.track_scan`) runs for every
coherent block longer than 2 ms, through its prepared form `WindowsPlan`.  Its kernel is the second entry point of
`csrc/corr_bank.cu` and replaces the TPU kernel
`gps_sdr_tpu/ops/pallas_correlator.py::correlator_bank`; its plain version,
`correlator_bank_windows_reference`, is `correlate_blocks` with the
windows as the chunk.  Both entries share one device function and one
plain function, so on the same samples they agree bit for bit.  A 10 ms
block at 58 MHz is 1.16 MB per channel, so this entry is bound by bytes;
`default_split` gives a channel one CTA on each of its share of the SMs,
fewer where a block is too short to be worth that many CTAs.

Each wrapper takes the plain version for a tensor on the CPU and the
kernel for a CUDA tensor; there is no fallback between them.  Nothing is
clamped silently: a window that leaves the chunk, a block length outside
[1, blk] or an NCO word that is not finite raises the `fault` flag, which
`raise_on_fault` turns into an error.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gps_sdr_tpu_torch.ops import _build
from gps_sdr_tpu_torch.ops.cacode import CODE_LENGTH
from gps_sdr_tpu_torch.ops.track_chunk import (MAX_TAPS, Q32, BlockGrid,
                                               _wrap32, correlate_blocks)

SM_COUNT = 132        # H100
MIN_PART_ROWS = 12    # a part is worth its launch from 12 rows of 128 samples
CODE_PAD = 64         # chips of the code repeated on either side of the table
TABLE_LEN = CODE_PAD + CODE_LENGTH + CODE_PAD + 1   # whole 16-byte pieces


class BankTables(NamedTuple):
    """What the kernels need of a track that is made once, not per block:
    its codes and taps as they read them."""

    code: torch.Tensor    # (N, TABLE_LEN) float64: entry i is chip
    #                       (i − CODE_PAD) mod 1023, so an index kept along a
    #                       run of samples needs no wrap inside the pad
    taps: torch.Tensor    # (MAX_TAPS + 2,) int64: the Q32 tap offsets, zeros
    #                       past the last, then the least and the largest
    ntaps: int


def bank_tables(chips: torch.Tensor, tap_fp: torch.Tensor) -> BankTables:
    """The tables of `chips` (N, 1023) float32 and `tap_fp` (T,) int64 on
    their device: once per track, or per chunk, not per block."""
    idx = torch.remainder(
        torch.arange(TABLE_LEN, device=chips.device) - CODE_PAD, CODE_LENGTH)
    taps = torch.zeros(MAX_TAPS + 2, dtype=torch.int64, device=tap_fp.device)
    ntaps = tap_fp.shape[0]
    taps[:ntaps] = tap_fp
    taps[MAX_TAPS] = tap_fp.min()
    taps[MAX_TAPS + 1] = tap_fp.max()
    return BankTables(chips[:, idx].to(torch.float64).contiguous(), taps,
                      ntaps)


def tap_offsets_fp(taps: Sequence[float], device) -> torch.Tensor:
    """(T,) int64 Q32 tap offsets on `device`, rounded half to even like
    jnp.round.  Made once by the caller, not per block."""
    fp = np.round(np.asarray(taps, np.float64) * Q32).astype(np.int64)
    return torch.as_tensor(fp, device=device)


def new_fault(device) -> torch.Tensor:
    """A cleared fault flag: (1,) int32 on `device`."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _check_inputs(raw, words, n, chips, tap_fp, blk, fault) -> None:
    """`words`: the per-channel (n,) tensors by name, int64 except
    `rem_chip` and `code_freq` (float64)."""
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


class _LaunchArgs(ctypes.Structure):
    """`CorrBankArgs` of csrc/corr_bank.cu, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("raw", "code", "taps", "corr", "partial", "ticket",
                 "fault")] \
        + [("n_raw", ctypes.c_longlong), ("fs", ctypes.c_double)] \
        + [(name, ctypes.c_int) for name in
           ("raw_int16", "windows", "n_ch", "ntaps", "n_split", "blk",
            "remove_dc", "threads", "device")]


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    path, _, _ = _build.build_library("corr_bank")
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.corr_bank_launch.argtypes = [ctypes.POINTER(_LaunchArgs),
                                     ctypes.POINTER(p), p]
    lib.corr_bank_launch.restype = i
    lib.corr_bank_empty_launch.argtypes = [p]
    lib.corr_bank_empty_launch.restype = i
    lib.corr_bank_error_string.argtypes = [i]
    lib.corr_bank_error_string.restype = ctypes.c_char_p
    return lib


def default_split(n_ch: int, blk: int) -> int:
    """CTAs per channel for a block window of `blk` samples: one wave with
    one CTA an SM (a second CTA on an SM shares its dispatch slots, and a wave
    that does not fill evenly waits for its fullest SM), cut down for a
    short block until a part is `MIN_PART_ROWS` rows long (below that the
    launch and what closes it are the floor, and more parts only add to
    them: parts of 14 rows still measured better than parts of 28, parts
    of 7 no better than 14).  Both limits are what measured best on the
    card at 1 and 10 ms, 3 to 29 taps, 2 to 12 channels, DC removal on and
    off."""
    return max(1, min(SM_COUNT // n_ch, blk // 128 // MIN_PART_ROWS))


def threads_for(ntaps: int) -> int:
    """The most threads a correlating CTA of `ntaps` taps may have: that of
    the instance csrc/corr_bank.cu launches for it (`threads_for` of
    csrc/nco_common.cuh).  Only the E/P/L instance, compiled for 3 taps,
    leaves room for 16 warps; every other tap count runs an instance built
    for 8 (the 25- and 29-tap ones, or the one that reads its tap count at
    run time)."""
    return 512 if ntaps == 3 else 256


def default_threads(ntaps: int, n_split: int, blk: int) -> int:
    """Threads of a correlating CTA: `threads_for` where a part holds at
    least two runs of 8 samples for each of them (a 10 ms block), else 256.
    A part of a 1 ms block is about one run for each of 512 threads; with
    half the warps the barriers and the sum over warps are shorter, which
    measured best there (and 128 no better)."""
    runs = -(-blk // n_split) // 8
    return threads_for(ntaps) if runs >= 2 * threads_for(ntaps) else 256


def part_share(num: int, n_split: int, part: int) -> Tuple[int, int]:
    """Samples [lo, hi) of a block of `num` that part `part` of `n_split`
    correlates: whole 128-sample rows, the kernel's rule (`part_share` in
    csrc/corr_bank.cu), kept here for the tests that hold it."""
    rows = (num + 127) >> 7
    rows_per = -(-rows // n_split)
    lo = part * rows_per * 128
    return min(num, lo), min(num, lo + rows_per * 128)


_WORDS = ("ptr_off", "rem_chip", "code_freq", "phase_fp", "carr_fp", "num")
_WORD_DTYPE = dict(zip(_WORDS, (torch.int64, torch.float64, torch.float64,
                                torch.int64, torch.int64, torch.int64)))


class _KernelCall:
    """The buffers and the argument block of the C entry point, and the
    launch: of the fetching entry for one chunk (`raw`), or of the windows
    entry (`raw` None) for the windows each launch is given.  The scratch is
    the call's own: launches of one call follow each other on a stream, two
    calls may run side by side."""

    def __init__(self, raw, tables, fs, blk, remove_dc, fault, n_split):
        dev = fault.device
        n, ntaps = tables.code.shape[0], tables.ntaps
        if raw is not None and not raw.is_contiguous():
            raise ValueError("the chunk must be contiguous")
        if n_split is None:
            n_split = default_split(n, blk)
        self.lib = load_library()
        self.device = dev
        self.keep = (raw, tables, fault)    # what the pointers point at
        self.captured = 0    # launches recorded into CUDA graphs, not run
        self.corr_shape = (n, ntaps, 2)
        # the fetching entry's result is the call's own buffer
        self.corr = None if raw is None else torch.empty(
            self.corr_shape, dtype=torch.float32, device=dev)
        # one zeroed buffer: per part the tap sums, then its integer sums
        # for DC removal; behind them the channels' int32 tickets, how many
        # parts have arrived, which every launch puts back to zero
        slots = n * n_split * (ntaps + 1) * 2
        self.scratch = torch.zeros(slots + (n + 1) // 2, dtype=torch.float64,
                                   device=dev)
        self.partial = self.scratch[:slots].view(n, n_split, ntaps + 1, 2)
        self.args = _LaunchArgs(
            raw=None if raw is None else raw.data_ptr(),
            code=tables.code.data_ptr(), taps=tables.taps.data_ptr(),
            corr=None if raw is None else self.corr.data_ptr(),
            partial=self.scratch.data_ptr(),
            ticket=self.scratch.data_ptr() + 8 * slots,
            fault=fault.data_ptr(),
            n_raw=n * blk if raw is None else raw.shape[0], fs=float(fs),
            raw_int16=int(raw is not None and raw.dtype == torch.int16),
            windows=int(raw is None),
            n_ch=n, ntaps=ntaps, n_split=int(n_split), blk=int(blk),
            remove_dc=int(remove_dc),
            threads=default_threads(ntaps, int(n_split), int(blk)),
            device=dev.index or 0)
        self.args_ref = ctypes.byref(self.args)
        self.words = (ctypes.c_void_p * 6)()

    def launch(self, wrapper, words, win=None) -> torch.Tensor:
        """One launch on the current stream; `words` in the order of
        `_WORDS` (ptr_off None for the windows entry, whose windows are
        `win` and whose result is a new tensor).  Counted on `wrapper` when
        the kernel runs; on a stream that is being captured into a CUDA
        graph nothing runs, and the launch is counted on `captured` for
        whoever replays the graph."""
        corr = self.corr
        if win is not None:
            corr = torch.empty(self.corr_shape, dtype=torch.float32,
                               device=self.device)
            self.args.raw, self.args.corr = win.data_ptr(), corr.data_ptr()
            self.args.raw_int16 = int(win.dtype == torch.int16)
        slots = self.words
        for i, t in enumerate(words):
            slots[i] = None if t is None else t.data_ptr()
        rc = self.lib.corr_bank_launch(
            self.args_ref, slots,
            torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"{wrapper.__name__}: kernel launch failed: "
                + self.lib.corr_bank_error_string(rc).decode())
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            wrapper.launches += 1
        return corr


def _check_words(words, names, shape, device) -> None:
    """The per-block words of a prepared launch, at every call."""
    for t, name in zip(words, names):
        dtype = _WORD_DTYPE[name]
        if t.dtype != dtype or t.shape != shape or t.device != device \
                or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {tuple(shape)} {dtype} on "
                f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


class BankPlan:
    """A prepared `correlator_bank`: everything that stays the same from
    one block of a chunk to the next is checked, allocated and laid out for
    the kernel once, and a call takes the six per-block words.

        plan = BankPlan(raw, chips, tap_fp, fs, blk, remove_dc, fault)
        corr = plan(ptr_off, rem_chip, code_freq, phase_fp, carr_fp, num)

    On a CUDA device `corr` (N, T, 2) float32 is the plan's own buffer,
    overwritten by the next call: copy what is to be kept.  On the CPU a
    call runs the plain version.  The words must be contiguous (N,) tensors
    of their dtypes on the plan's device; a call checks only that.  It
    launches on the current stream and counts on
    `correlator_bank.launches`.  It can be captured into a CUDA graph:
    every pointer but the words' is fixed.  A captured call launches
    nothing and is counted on `captured` instead; whoever replays the graph
    adds what it holds to `correlator_bank.launches`.  `n_split` is for
    measurements; the default is what measured best.
    """

    def __init__(self, raw: torch.Tensor, chips: torch.Tensor,
                 tap_fp: torch.Tensor, fs: float, blk: int,
                 remove_dc: bool = False,
                 fault: Optional[torch.Tensor] = None,
                 grid: Optional[BlockGrid] = None,
                 n_split: Optional[int] = None):
        _check_raw(raw)
        dev = raw.device
        if fault is None:
            fault = new_fault(dev)
        _check_inputs(raw, {}, chips.shape[0], chips, tap_fp, blk, fault)
        self.fault, self.device = fault, dev
        self.shape = torch.Size((chips.shape[0],))
        if dev.type == "cpu":
            if grid is None:
                grid = BlockGrid.make(blk, dev)
            self._plain = (chips, tap_fp, fs, blk, remove_dc, fault, grid)
            self._raw = raw
        elif dev.type == "cuda":
            self._call = _KernelCall(
                raw, bank_tables(chips.contiguous(), tap_fp), fs, blk,
                remove_dc, fault, n_split)
        else:
            raise ValueError(f"correlator_bank: no kernel for {dev}")

    @property
    def captured(self) -> int:
        """Calls recorded into CUDA graphs so far (0 on the CPU)."""
        return self._call.captured if self.device.type == "cuda" else 0

    def __call__(self, ptr_off: torch.Tensor, rem_chip: torch.Tensor,
                 code_freq: torch.Tensor, phase_fp: torch.Tensor,
                 carr_fp: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
        words = (ptr_off, rem_chip, code_freq, phase_fp, carr_fp, num)
        _check_words(words, _WORDS, self.shape, self.device)
        if self.device.type == "cpu":
            return correlator_bank_reference(self._raw, *words,
                                             *self._plain)[0]
        return self._call.launch(correlator_bank, words)


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
    `fault` back with `raise_on_fault` when the results are.  This is the
    checked entry that makes its tables and buffers on every call; a caller
    with many blocks of one chunk keeps a `BankPlan`.
    """
    plan = BankPlan(raw, chips, tap_fp, fs, blk, remove_dc, fault, grid,
                    n_split)
    # the (N,) words may be views (a column of a packed state): no copy
    # when they are contiguous already
    corr = plan(*(t.contiguous() for t in (ptr_off, rem_chip, code_freq,
                                           phase_fp, carr_fp, num)))
    return corr, plan.fault


correlator_bank.launches = 0   # kernel launches (the CUDA path only)


class WindowsPlan:
    """A prepared `correlator_bank_windows` for many blocks of one window
    length: what stays the same from block to block is checked once, the
    tables and the scratch are made once, and a call takes the windows and
    the five per-block words.

        plan = WindowsPlan(chips, tap_fp, fs, blk, remove_dc, fault)
        corr = plan(win, rem_chip, code_freq, phase_fp, carr_fp, num)

    `corr` (N, T, 2) float32 is a new tensor at every call.  `win` must be
    a contiguous (N, blk, 2) int8/int16 tensor and the words contiguous
    (N,) tensors of their dtypes, all on the device of `chips`; a call
    checks only that.  On the CPU a call runs the plain version.  A call
    launches on the current stream and counts on
    `correlator_bank_windows.launches` (a captured call on `captured`, as
    `BankPlan`); calls of one plan follow each other on one stream.
    """

    def __init__(self, chips: torch.Tensor, tap_fp: torch.Tensor, fs: float,
                 blk: int, remove_dc: bool = False,
                 fault: Optional[torch.Tensor] = None,
                 grid: Optional[BlockGrid] = None,
                 n_split: Optional[int] = None):
        dev = chips.device
        if fault is None:
            fault = new_fault(dev)
        n = chips.shape[0]
        _check_inputs(chips, {}, n, chips, tap_fp, blk, fault)
        self.fault, self.device = fault, dev
        self.shape, self.win_shape = torch.Size((n,)), (n, blk, 2)
        if dev.type == "cpu":
            if grid is None:
                grid = BlockGrid.make(blk, dev)
            self._plain = (chips, tap_fp, fs, remove_dc, fault, grid)
        elif dev.type == "cuda":
            self._call = _KernelCall(
                None, bank_tables(chips.contiguous(), tap_fp), fs, blk,
                remove_dc, fault, n_split)
        else:
            raise ValueError(f"correlator_bank_windows: no kernel for {dev}")

    @property
    def captured(self) -> int:
        """Calls recorded into CUDA graphs so far (0 on the CPU)."""
        return self._call.captured if self.device.type == "cuda" else 0

    def __call__(self, win: torch.Tensor, rem_chip: torch.Tensor,
                 code_freq: torch.Tensor, phase_fp: torch.Tensor,
                 carr_fp: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
        if win.dtype not in (torch.int8, torch.int16) \
                or win.shape != self.win_shape or win.device != self.device \
                or not win.is_contiguous():
            raise ValueError(
                f"win must be a contiguous {self.win_shape} int8/int16 IQ "
                f"tensor on {self.device}, got {tuple(win.shape)} "
                f"{win.dtype} on {win.device}")
        words = (rem_chip, code_freq, phase_fp, carr_fp, num)
        _check_words(words, _WORDS[1:], self.shape, self.device)
        if self.device.type == "cpu":
            return correlator_bank_windows_reference(win, *words,
                                                     *self._plain)[0]
        return self._call.launch(correlator_bank_windows, (None, *words),
                                 win)


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
    raises.  Neither synchronises with the host.  This is the checked
    entry that makes its tables and scratch on every call; a caller with
    many blocks keeps a `WindowsPlan`.
    """
    if fault is None:
        fault = new_fault(win.device)
    if win.dtype not in (torch.int8, torch.int16) or win.dim() != 3 \
            or win.shape[2] != 2:
        raise ValueError(f"win must be (N, blk, 2) int8/int16 IQ, got "
                         f"{tuple(win.shape)} {win.dtype}")
    words = dict(num=num, phase_fp=phase_fp, carr_fp=carr_fp,
                 rem_chip=rem_chip, code_freq=code_freq)
    _check_inputs(win, words, num.shape[0], chips, tap_fp, win.shape[1],
                  fault)
    if win.shape[0] != num.shape[0]:
        raise ValueError(f"win holds {win.shape[0]} windows for "
                         f"{num.shape[0]} channels")
    plan = WindowsPlan(chips, tap_fp, fs, win.shape[1], remove_dc, fault,
                       grid, n_split)
    return plan(win.contiguous(), *(t.contiguous() for t in (
        rem_chip, code_freq, phase_fp, carr_fp, num))), fault


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
