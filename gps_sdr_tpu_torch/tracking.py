"""Chunked DLL/PLL tracking driver.

Channels are a batch dimension; time advances chunk by chunk.  Each chunk
of raw IQ crosses to the device once (native int8/int16, cast on the
device).  Coherent blocks of up to 2 ms go through one
`ops.track_chunk.track_chunk` call per chunk, which runs every block of it
for all channels: the CUDA kernel on the card, the plain PyTorch version on
the CPU.  Longer blocks (the 10 ms phases of the reference's schedules) go
block by block through `track_scan`: each channel's window is cut out of
the chunk on the device, `ops.corr_bank.correlator_bank_windows`
correlates it, and the loops close in float64 tensors on the device.  On
the card `run_tracking` replays a chunk's blocks from one CUDA graph
(`ScanGraph`), captured once a call over a fixed sample buffer.

The loop state is kept exact as in the JAX scan (gps_sdr_tpu/tracking.py):
the carrier phase is an int32 Q32 accumulator that wraps exactly mod one
cycle, the code chip index an exact Q32 accumulator, and the NCO and
loop-filter scalars are float64.  Loop behaviour (discriminators,
2nd-order filters, update order, the reference's stage-specific sign and
offset quirks) follows the reference:
- trackingCT.m:137-150   DLL/PLL recurrences, codeFreq = basis − nco
- trackingCT_POS_updated.m:210-270  E/P/L from the 25-tap grid with the
  +0.05-chip prompt offset, codeFreq = basis + nco, ceil() block length

With a mesh (`parallel/mesh.py`) `run_tracking` shards the channel axis
over a world of ranks on both routes, `track_chunk` and `track_scan`
(`parallel/tracking.py`).  The JAX package leaves its whole-chunk Pallas
kernel unsharded (gps_sdr_tpu/tracking.py:594-600) and shards every other
pdi-1 engine; here `track_chunk` is the only pdi-1 engine, and a channel's
result does not depend on how many channels share its launch, so it is
sharded like the rest.  A resident capture (time-segmented tracking) runs
unsharded with a warning, as the JAX package does with per-channel windows
(gps_sdr_tpu/tracking.py:587-592).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.io.ifdata import ChunkFeed, IFSampleSource
from gps_sdr_tpu_torch.ops import corr_bank
from gps_sdr_tpu_torch.ops import track_chunk as tc
from gps_sdr_tpu_torch.ops.cacode import ca_code_table
from gps_sdr_tpu_torch.ops.loops import loop_coefficients
from gps_sdr_tpu_torch.ops.track_chunk import (ChunkSpec, raise_on_fault,
                                               track_chunk)
from gps_sdr_tpu_torch.utils.device import capture_graph, resolve_device
from gps_sdr_tpu_torch.utils.spans import span

Q32 = 4294967296.0  # 2**32
_REC_FIELDS = ("corr", "code_err", "carr_err", "code_freq", "carr_freq",
               "num_sample", "rem_chip", "rem_phase", "absolute_sample")


class TrackState(NamedTuple):
    """Per-channel tracking carry; every field is a (N,) tensor."""

    ptr: torch.Tensor              # int64 absolute sample of the next block
    rem_chip: torch.Tensor         # float64 code phase remainder [chips]
    code_freq: torch.Tensor        # float64 [Hz]
    carr_freq: torch.Tensor        # float64 [Hz]
    carr_freq_basis: torch.Tensor  # float64 [Hz]
    phase_fp: torch.Tensor         # int32 Q32 carrier phase
    dll_nco: torch.Tensor          # float64 loop-filter accumulators
    dll_last: torch.Tensor
    pll_nco: torch.Tensor
    pll_last: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrackParams:
    """Static configuration of one tracking segment."""

    pdi_ms: int                    # coherent integration [ms]
    taps: Tuple[float, ...]        # correlator offsets [chips]
    i_early: int
    i_prompt: int
    i_late: int
    dll_freq_sign: float = -1.0    # codeFreq = basis + sign·nco
    negate_iq: bool = False        # the 10 ms eph phase negates outputs
    rounding: str = "round"        # block length: "round" (trackingCT)
                                   # or "ceil" (POS/VT stages)
    dll_bw_hz: float = 2.0
    dll_damping: float = 0.707
    dll_gain: float = 0.1
    pll_bw_hz: float = 15.0
    pll_damping: float = 0.707
    pll_gain: float = 0.25
    loop_dt_s: float = 1e-3        # the reference integrates with 0.001
    remove_dc: bool = False        # int16 front-ends

    @staticmethod
    def _loop_kw(cfg: ReceiverConfig) -> dict:
        t = cfg.track
        return dict(dll_bw_hz=t.dll_bw_hz, dll_damping=t.dll_damping,
                    dll_gain=t.dll_gain, pll_bw_hz=t.pll_bw_hz,
                    pll_damping=t.pll_damping, pll_gain=t.pll_gain,
                    remove_dc=cfg.file.data_precision == 2)

    @staticmethod
    def epl(cfg: ReceiverConfig, pdi_ms: int = 1, **kw) -> "TrackParams":
        """trackingCT-style 3-tap [−d, 0, +d] configuration."""
        d = cfg.track.correlator_spacing
        args = dict(pdi_ms=pdi_ms, taps=(-d, 0.0, d), i_early=0, i_prompt=1,
                    i_late=2, dll_freq_sign=-1.0, **TrackParams._loop_kw(cfg))
        args.update(kw)
        return TrackParams(**args)

    @staticmethod
    def pos_epl(cfg: ReceiverConfig, pdi_ms: int = 1, **kw) -> "TrackParams":
        """CT-POS 3-tap configuration: taps (+0.5, +0.05, −0.5) with the
        prompt-offset quirk, ceil block length, codeFreq = basis + nco
        (trackingCT_POS_updated.m:210-217,262)."""
        d = cfg.track.correlator_spacing
        args = dict(pdi_ms=pdi_ms, taps=(d, 0.05, -d), i_early=0,
                    i_prompt=1, i_late=2, dll_freq_sign=+1.0,
                    rounding="ceil", **TrackParams._loop_kw(cfg))
        args.update(kw)
        return TrackParams(**args)

    @staticmethod
    def pos_multicorr(cfg: ReceiverConfig, pdi_ms: int = 1, **kw
                      ) -> "TrackParams":
        """25-tap grid 0.6:−0.05:−0.6 (trackingCT_POS_updated.m:42); the
        loop closes on the ±0.5/P taps (indices 2/12/22), with the
        +0.05-chip prompt quirk folded into the prompt tap."""
        grid = [round(0.6 - 0.05 * i, 4) for i in range(25)]
        grid[12] = 0.05
        args = dict(pdi_ms=pdi_ms, taps=tuple(grid), i_early=2,
                    i_prompt=12, i_late=22, dll_freq_sign=+1.0,
                    rounding="ceil", **TrackParams._loop_kw(cfg))
        args.update(kw)
        return TrackParams(**args)

    def chunk_spec(self, cfg: ReceiverConfig) -> ChunkSpec:
        return ChunkSpec(
            taps=tuple(float(t) for t in self.taps),
            epl=(self.i_early, self.i_prompt, self.i_late),
            pdi_ms=self.pdi_ms, ceil_rounding=self.rounding == "ceil",
            sign=-1.0 if self.negate_iq else 1.0, remove_dc=self.remove_dc,
            dll_freq_sign=float(self.dll_freq_sign),
            tau_c=loop_coefficients(self.dll_bw_hz, self.dll_damping,
                                    self.dll_gain),
            tau_r=loop_coefficients(self.pll_bw_hz, self.pll_damping,
                                    self.pll_gain),
            dt=float(self.loop_dt_s), fs=float(cfg.signal.fs),
            code_freq_basis=float(cfg.signal.code_freq_basis))


def init_track_state(cfg: ReceiverConfig, code_delays, fine_freqs,
                     device=None) -> TrackState:
    """Initial state from acquisition results.  File-pointer convention of
    trackingCT.m:63 / trackingCT_POS_updated.m:108-110: start at absolute
    sample skip·S + S − codedelay + 1.  Tensors on `device` (the card when
    None)."""
    device = resolve_device(device)
    S = cfg.signal.samples_per_ms
    delays = np.asarray(code_delays, np.int64)
    n = len(delays)
    f64 = dict(dtype=torch.float64, device=device)
    fine = torch.as_tensor(np.asarray(fine_freqs, np.float64), **f64)
    return TrackState(
        ptr=torch.as_tensor(cfg.file.skip_ms * S + S - delays + 1,
                            dtype=torch.int64, device=device),
        rem_chip=torch.zeros(n, **f64),
        code_freq=torch.full((n,), float(cfg.signal.code_freq_basis), **f64),
        carr_freq=fine.clone(), carr_freq_basis=fine.clone(),
        phase_fp=torch.zeros(n, dtype=torch.int32, device=device),
        dll_nco=torch.zeros(n, **f64), dll_last=torch.zeros(n, **f64),
        pll_nco=torch.zeros(n, **f64), pll_last=torch.zeros(n, **f64))


@dataclasses.dataclass
class TrackRecords:
    """Struct-of-arrays tracking log on the host, (T, N) per field — the
    reference's TckResult struct transposed (trackingCT.m:153-170)."""

    corr: np.ndarray           # (T, N, ntaps, 2) I/Q correlator bank
    code_err: np.ndarray
    carr_err: np.ndarray
    code_freq: np.ndarray
    carr_freq: np.ndarray
    num_sample: np.ndarray
    rem_chip: np.ndarray
    rem_phase: np.ndarray
    absolute_sample: np.ndarray
    i_early: int = 0
    i_prompt: int = 1
    i_late: int = 2

    @property
    def p_i(self):
        return self.corr[:, :, self.i_prompt, 0]

    @property
    def p_q(self):
        return self.corr[:, :, self.i_prompt, 1]

    @property
    def e_i(self):
        return self.corr[:, :, self.i_early, 0]

    @property
    def l_i(self):
        return self.corr[:, :, self.i_late, 0]

    @staticmethod
    def concatenate(parts) -> "TrackRecords":
        return TrackRecords(*[np.concatenate([getattr(p, f) for p in parts])
                              for f in _REC_FIELDS],
                            i_early=parts[0].i_early,
                            i_prompt=parts[0].i_prompt,
                            i_late=parts[0].i_late)


def state_from_records(records: TrackRecords, rows, carr_freq_basis,
                       dll_freq_sign: float = -1.0,
                       code_freq_basis: float = 1.023e6,
                       device=None) -> TrackState:
    """The carry as it was after record row `rows[ch]` of each channel:
    the Q32 phase round-trips through rem_phase and the loop-filter
    accumulators invert from the recorded frequencies
    (dll = sign·(codeFreq − basis); pll = carrFreq − carrBasis).  Tensors
    on `device` (the card when None)."""
    device = resolve_device(device)
    n = records.absolute_sample.shape[1]
    sel = (np.asarray(rows, np.int64), np.arange(n))
    code_freq = records.code_freq[sel]
    carr_freq = records.carr_freq[sel]
    basis = np.asarray(carr_freq_basis, np.float64)
    phase_fp = (np.round(records.rem_phase[sel] / (2.0 * np.pi) * Q32)
                .astype(np.int64).astype(np.int32))

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return TrackState(
        ptr=t(records.absolute_sample[sel], torch.int64),
        rem_chip=t(records.rem_chip[sel]), code_freq=t(code_freq),
        carr_freq=t(carr_freq), carr_freq_basis=t(basis),
        phase_fp=t(phase_fp, torch.int32),
        dll_nco=t(dll_freq_sign * (code_freq - code_freq_basis)),
        dll_last=t(records.code_err[sel]),
        pll_nco=t(carr_freq - basis), pll_last=t(records.carr_err[sel]))


def chip_tables(prns, device=None) -> torch.Tensor:
    """(N, 1023) float32 ±1 codes, one row per channel, on `device` (the
    card when None)."""
    device = resolve_device(device)
    return torch.as_tensor(np.stack([ca_code_table()[int(p) - 1]
                                     for p in prns]),
                           dtype=torch.float32, device=device)


def _scan_blocks(raw: torch.Tensor, chunk_start, state: TrackState,
                 plan: corr_bank.WindowsPlan, k: tc.LoopConsts,
                 spec: ChunkSpec, n_steps: int):
    """`n_steps` blocks of `track_scan` from `state`, with nothing read back
    and no check of the windows: (records, end state).  `chunk_start` is an
    int or a 0-d int64 tensor on the device."""
    cut = corr_bank.WindowCutter(raw, spec.window.blk)

    def bank(b: tc.BlockNCO) -> torch.Tensor:
        return plan(cut(b.ptr - chunk_start), *(t.contiguous() for t in (
            b.rem_chip, b.code_freq, b.phase, b.carr_fp, b.num)))

    st = state._replace(phase_fp=state.phase_fp.to(torch.int64))
    rows = []
    for _ in range(n_steps):
        st, row, _ = tc.block_step(st, spec, k, bank)
        rows.append(row)
    rec = tc.stack_rows(rows, plan.fault, state.ptr.shape[0], len(spec.taps))
    return rec, st._replace(phase_fp=st.phase_fp.to(torch.int32))


def _scan_plan(chips: torch.Tensor, spec: ChunkSpec):
    """The bank's plan, with a new fault flag, and the loops' constants:
    made once for a scan, outside any capture."""
    dev, blk = chips.device, spec.window.blk
    grid = tc.BlockGrid.make(blk, dev) if dev.type == "cpu" else None
    tap_fp = torch.as_tensor(spec.tap_fp(), device=dev)
    plan = corr_bank.WindowsPlan(chips, tap_fp, spec.fs, blk,
                                 spec.remove_dc, corr_bank.new_fault(dev),
                                 grid)
    return plan, tc.LoopConsts.make(spec, dev)


def _flag_windows(rec: dict, chunk_start: int, blk: int, length: int
                  ) -> None:
    """Raise the records' fault for a window that left the chunk's
    `length` samples, from the records' offsets (the cutter clamps)."""
    if rec["num_sample"].shape[0]:
        off = rec["absolute_sample"] - rec["num_sample"] - chunk_start
        corr_bank.raise_flag(
            rec["fault"], ((off < 0) | (off + blk > length)).any(dim=0))


def track_scan(raw: torch.Tensor, chunk_start: int, state: TrackState,
               chips: torch.Tensor, spec: ChunkSpec, n_steps: int):
    """Track all channels for `n_steps` blocks of one chunk, block by block.

    Arguments and result as `ops.track_chunk.track_chunk`.  Per block each
    channel's window of `spec.window.blk` samples is cut at ptr − chunk_start
    (`corr_bank.WindowCutter`), `correlator_bank_windows`, prepared once
    for the scan (`corr_bank.WindowsPlan`), correlates the windows (the
    CUDA kernel for a chunk on the card, its plain version on the CPU) and `block_step` closes the loops: the arithmetic of
    `track_chunk_reference`, so on the CPU the two agree bit for bit.

    Nothing inside the loop synchronises with the host: block lengths and
    pointers stay on the device.  `records["fault"]` is 1 + the last
    channel whose window left the chunk, whose block length left
    [1, blk] or whose NCO words were not finite; `raise_on_fault` reads it
    with the records.
    """
    tc.check_inputs(raw, state, chips, spec, n_steps, chunk_start)
    plan, k = _scan_plan(chips, spec)
    rec, st = _scan_blocks(raw, chunk_start, state, plan, k, spec, n_steps)
    _flag_windows(rec, chunk_start, spec.window.blk, raw.shape[0])
    return rec, st


class ScanGraph:
    """`run_tracking`'s tracker on the graph route (`uses_scan_graph`),
    called as `track_scan` is and giving its records and end state bit
    for bit.  A chunk's blocks are scanned over fixed tensors (a sample
    buffer of the first window plus `slack` samples, `chunk_start` as a
    device scalar, the state, the records), captured into a CUDA graph
    (span `tracking.capture`, n the blocks) on the first chunk and again
    when a window outgrows the buffer, and replayed per chunk
    (`tracking.replay`); a chunk of another number of blocks (a short last
    one) runs `track_scan` eagerly.  Off a CUDA device a replay runs the
    scan eagerly over the same tensors.

    A replay copies the chunk to the buffer's head and the state in
    (unless it is the one the last call returned); the scan writes its end
    state back.  Records and state are the object's own, overwritten by
    the next call.  The window check after the scan, outside the graph,
    holds the records to the chunk's own length, as `track_scan` does.  A
    replay adds the bank launches its graph holds (`held`) to
    `correlator_bank_windows.launches`, as a replayed VT step does."""

    def __init__(self, slack: int):
        self.slack = slack
        self.n_steps = self.capacity = self.graph = None

    def _capture(self, raw: torch.Tensor, state: TrackState,
                 chips: torch.Tensor, spec: ChunkSpec, n_steps: int) -> None:
        self.graph = self.rec = self.buf = None    # the old ones go first
        dev = chips.device
        self.capacity = raw.shape[0] + self.slack
        self.chips, self.spec, self.n_steps = chips, spec, n_steps
        self.buf = torch.zeros((self.capacity, 2), dtype=raw.dtype,
                               device=dev)
        self.start = torch.zeros((), dtype=torch.int64, device=dev)
        self.state = TrackState(*(t.clone() for t in state))
        self.plan, self.k = _scan_plan(chips, spec)
        self.held = 0
        if dev.type == "cuda":
            before = self.plan.captured
            self.graph = capture_graph(self._scan, dev)
            self.held = self.plan.captured - before

    def _scan(self) -> None:
        self.plan.fault.zero_()
        self.rec, st = _scan_blocks(self.buf, self.start, self.state,
                                    self.plan, self.k, self.spec,
                                    self.n_steps)
        for dst, src in zip(self.state, st):
            dst.copy_(src)

    def _replay(self, raw: torch.Tensor, chunk_start: int,
                state: TrackState):
        tc.check_inputs(raw, state, self.chips, self.spec, self.n_steps,
                        chunk_start)
        self.buf[:raw.shape[0]].copy_(raw)
        self.start.fill_(chunk_start)
        if state is not self.state:
            for dst, src in zip(self.state, state):
                dst.copy_(src)
        if self.graph is None:
            self._scan()
        else:
            self.graph.replay()
            corr_bank.correlator_bank_windows.launches += self.held
        _flag_windows(self.rec, chunk_start, self.spec.window.blk,
                      raw.shape[0])
        return self.rec, self.state

    def __call__(self, raw: torch.Tensor, chunk_start: int,
                 state: TrackState, chips: torch.Tensor, spec: ChunkSpec,
                 n_steps: int):
        if self.n_steps is not None and n_steps != self.n_steps:
            return track_scan(raw, chunk_start, state, chips, spec, n_steps)
        if self.n_steps is None or raw.shape[0] > self.capacity:
            with span("tracking.capture", n_steps):
                self._capture(raw, state, chips, spec, n_steps)
        with span("tracking.replay", n_steps):
            return self._replay(raw, chunk_start, state)


def uses_scan_graph(device: torch.device, pdi_ms: int, staged: bool,
                    sharded: bool, n_blocks: int, blocks_per_chunk: int
                    ) -> bool:
    """Whether `run_tracking` runs its blocks through a `ScanGraph`: blocks
    of `track_scan` (longer than 2 ms) on a CUDA device, read chunk by
    chunk (not from a resident capture), not sharded over a mesh (its
    collectives cannot be captured), over more than one chunk (a single
    chunk cannot pay for a capture)."""
    return (device.type == "cuda" and pdi_ms > 2 and staged and not sharded
            and n_blocks > blocks_per_chunk)


def run_tracking(source: IFSampleSource, cfg: ReceiverConfig, prns,
                 state: TrackState, params: TrackParams, n_ms: int,
                 chunk_ms: int = 1000,
                 resident: Optional[torch.Tensor] = None, mesh=None
                 ) -> Tuple[TrackRecords, TrackState]:
    """Track `n_ms` of signal ms from `state` (on its device), chunk by
    chunk of `chunk_ms`: one `track_chunk` call per chunk for coherent
    blocks of up to 2 ms, `track_scan` for longer ones
    (gps_sdr_tpu/tracking.py:550-554 routes them the same way).

    The chunks come from an `io.ifdata.ChunkFeed`: each chunk's window
    from the channels' pointers, the next chunk's read submitted before
    this chunk is staged, its tracker issued and its records read back.

    On the card, blocks longer than 2 ms of a staged, unsharded call of
    more than one chunk run through one `ScanGraph`: `track_scan` captured
    into a CUDA graph on the first chunk and replayed on every chunk of
    the same number of blocks, so the host launches a chunk's 100 blocks
    as one graph, not ~60 kernels a block; the records are the eager
    scan's bit for bit.  The CPU, a mesh, a resident capture, a single
    chunk and a chunk of another number of blocks run eagerly.

    `resident`: the whole capture already on the state's device
    (`io.ifdata.upload_capture`).  Every chunk then reads it in place, from
    chunk_start 0, with no read, staging or gather: the route for channels
    far apart in the capture (time-segmented tracking), where the span from
    the first pointer to the last is nearly the whole capture.

    `mesh` (a `parallel.mesh.Mesh`) shards the channel axis over its ranks:
    the channels padded to a multiple of its size with duplicates of
    channel 0, each rank tracking its slice from its own reads, the records
    and the end state gathered in rank order, so every rank returns those
    of all channels, bit for bit the unsharded run's.
    """
    if len(prns) == 0:
        raise ValueError("no channels to track (empty PRN list)")
    device = state.ptr.device
    S = cfg.signal.samples_per_ms
    spec = params.chunk_spec(cfg)
    chips = chip_tables(prns, device)
    need = int(state.ptr.max()) + (n_ms + 2) * S
    if need > source.n_samples:
        raise ValueError(
            f"capture too short: tracking {n_ms} ms needs ~{need} samples, "
            f"file has {source.n_samples}")
    n_blocks_total = n_ms // params.pdi_ms
    blocks_per_chunk = max(1, chunk_ms // params.pdi_ms)
    tracker, tracker_span = ((track_scan, "tracking.scan")
                             if params.pdi_ms > 2 else
                             (track_chunk, "tracking.track_chunk"))
    n_real = len(prns)
    use_mesh = mesh is not None and mesh.size > 1
    if use_mesh and resident is not None:
        warnings.warn("run_tracking: mesh is ignored with a resident capture "
                      "(time-segmented tracking runs on this rank's device "
                      "alone)", stacklevel=2)
        use_mesh = False
    if use_mesh:
        from gps_sdr_tpu_torch.parallel import tracking as ptrack
        state, chips, _ = ptrack.pad_channels(state, chips, mesh.size)
        state, chips = ptrack.shard_channels(mesh, state, chips)
        tracker = ptrack.sharded_tracker(mesh, tracker, n_real)
    feed = ChunkFeed(source, device, spec.window, resident)
    if uses_scan_graph(device, params.pdi_ms, resident is None, use_mesh,
                       n_blocks_total, blocks_per_chunk):
        tracker = ScanGraph(feed.slack)
    parts = []
    done = 0
    try:
        while done < n_blocks_total:
            nb = min(blocks_per_chunk, n_blocks_total - done)
            nb_next = min(blocks_per_chunk, n_blocks_total - done - nb)
            with span("tracking.chunk", nb):
                raw, start = feed.next(state.ptr, nb, nb_next)
                with span(tracker_span, nb):
                    rec, state = tracker(raw, start, state, chips, spec, nb)
                with span("tracking.records", nb):
                    raise_on_fault(rec)
                    parts.append(TrackRecords(
                        **{f: rec[f].cpu().numpy() for f in _REC_FIELDS},
                        i_early=params.i_early, i_prompt=params.i_prompt,
                        i_late=params.i_late))
            done += nb
    finally:
        feed.close()
    if use_mesh:
        state = ptrack.gather_state(mesh, state, n_real)
    return TrackRecords.concatenate(parts), state
