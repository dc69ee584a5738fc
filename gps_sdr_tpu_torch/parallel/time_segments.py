"""Time-segmented tracking: sequence parallelism for the serial scan.

The tracking loop is a serial recurrence: 40 s of eph tracking is 40 000
blocks one after the other, each far too small to fill the card.  This is
the overlap-save reformulation of the JAX package's
`gps_sdr_tpu/parallel/time_segments.py`: the code-period axis is cut into
D segments, each segment's NCO state is predicted from acquisition (code
periods advance at S/(1 + fd/fc) samples each, so after 16 s a 5 Hz
fine-Doppler error mispredicts the boundary by < 0.1 chip), every segment
tracks a halo of extra periods for the DLL/PLL to pull in, and the halos
are dropped at the stitch.  (channel × segment) is one batch of N·D
channels, so the chunks shrink by D and each launch carries D× the
channels.

I/O: the segments' pointers lie up to the whole capture apart, so the
capture goes to the device once (`io.ifdata.upload_capture`: one device
tensor, filled through a pinned buffer of bounded size) and every chunk's
`track_chunk` reads it in place from chunk_start 0 — no per-channel window
gathered on the host, no staging per chunk.  On the CPU the resident
capture is the source's values as a CPU tensor and the plain version
tracks it.

Row r of the stitched record is absolute code period r of each channel,
as in a serial run; only loop noise differs (near segment starts).  For
the bit-decoding stage; the POS stages track serially from their own
state.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource, upload_capture
from gps_sdr_tpu_torch.tracking import (_REC_FIELDS, TrackParams,
                                        TrackRecords, TrackState,
                                        init_track_state, run_tracking)
from gps_sdr_tpu_torch.utils.device import resolve_device


def segmented_initial_state(cfg: ReceiverConfig, code_delays, fine_freqs,
                            n_segments: int, seg_ms: int, halo_ms: int,
                            device=None) -> TrackState:
    """(N·D,)-channel state, segment-major: segment s of channel c is
    channel s·N + c and starts at the predicted code-period boundary
    round((s·seg − halo)·S/(1 + fd/fc)) past the acquisition pointer (0
    for s = 0), with the loops at rest.  Tensors on `device` (the card when
    None)."""
    device = resolve_device(device)
    n = len(code_delays)
    fine = np.asarray(fine_freqs, np.float64)
    base = init_track_state(cfg, code_delays, fine, "cpu")
    S = cfg.signal.samples_per_ms
    fd = fine - cfg.signal.f_if
    samples_per_period = S / (1.0 + fd / cfg.signal.fc)  # code Doppler

    ptrs = np.empty(n * n_segments, np.int64)
    for s in range(n_segments):
        start_period = max(0, s * seg_ms - halo_ms) if s else 0
        off = np.round(start_period * samples_per_period).astype(np.int64)
        ptrs[s * n:(s + 1) * n] = base.ptr.numpy() + off
    carr = np.tile(fine, n_segments)
    f64 = dict(dtype=torch.float64, device=device)
    m = n * n_segments
    return TrackState(
        ptr=torch.as_tensor(ptrs, device=device),
        rem_chip=torch.zeros(m, **f64),
        code_freq=torch.full((m,), float(cfg.signal.code_freq_basis), **f64),
        carr_freq=torch.as_tensor(carr, **f64),
        carr_freq_basis=torch.as_tensor(carr, **f64),
        phase_fp=torch.zeros(m, dtype=torch.int32, device=device),
        dll_nco=torch.zeros(m, **f64), dll_last=torch.zeros(m, **f64),
        pll_nco=torch.zeros(m, **f64), pll_last=torch.zeros(m, **f64))


def run_tracking_segmented(source: IFSampleSource, cfg: ReceiverConfig,
                           prns: Sequence[int], code_delays: np.ndarray,
                           fine_freqs: np.ndarray, params: TrackParams,
                           n_ms: int, n_segments: int = 8,
                           halo_ms: int = 400, chunk_ms: int = 1000,
                           device=None) -> TrackRecords:
    """Track `n_ms` code periods with D-way time parallelism on `device`
    (the card when None): the capture uploaded once, then one tracking run
    of seg_ms + halo_ms over the N·D batch reading it in place, then the
    stitch.

    Returns stitched (n_ms, N) records equivalent to a serial run (up to
    loop noise in the first ~halo of each segment's pull-in).
    """
    if params.pdi_ms != 1:
        raise ValueError("segmented tracking supports pdi=1 (bit stage)")
    n = len(prns)
    seg_ms = -(-n_ms // n_segments)            # ceil
    if halo_ms >= seg_ms:
        raise ValueError(f"halo ({halo_ms} ms) must be < segment length "
                         f"({seg_ms} ms); use fewer segments")
    device = resolve_device(device)
    state = segmented_initial_state(cfg, code_delays, fine_freqs,
                                    n_segments, seg_ms, halo_ms, device)
    prns_rep = [p for _ in range(n_segments) for p in prns]
    resident = upload_capture(source, device)
    rec, _ = run_tracking(source, cfg, prns_rep, state, params,
                          seg_ms + halo_ms, chunk_ms=chunk_ms,
                          resident=resident)
    del resident
    return stitch_segments(rec, n, n_segments, seg_ms, halo_ms, n_ms,
                           params)


def stitch_segments(rec: TrackRecords, n: int, n_segments: int,
                    seg_ms: int, halo_ms: int, n_ms: int,
                    params: TrackParams) -> TrackRecords:
    """Overlap-save stitch of a (seg_ms+halo, N·D) segmented record into
    the serial-equivalent (n_ms, N) record, in numpy as in the JAX package
    (the multi-process path will reuse it on records assembled across
    processes).

    The Costas PLL has a 180° ambiguity: each segment pulls in with an
    arbitrary polarity.  Segment s's halo rows cover the same absolute code
    periods as the tail of segment s−1's kept rows, so the median of the
    prompt signs' product over the last k = min(50, halo−1) of them says
    whether s is flipped against s−1; a flipped segment's correlators are
    negated.  Then each segment's halo is dropped and the whole cut to
    n_ms rows.
    """
    k_cmp = min(50, halo_ms - 1)
    flip = np.ones((n_segments, n), dtype=np.float32)
    p_i_all = rec.corr[:, :, params.i_prompt, 0]   # (seg+halo, N·D)
    for s in range(1, n_segments):
        prev = p_i_all[:, (s - 1) * n: s * n]
        cur = p_i_all[:, s * n: (s + 1) * n]
        lo_prev = 0 if s == 1 else halo_ms
        # absolute periods [s·seg−k, s·seg): prev rows, cur halo rows
        prev_rows = prev[lo_prev + seg_ms - k_cmp: lo_prev + seg_ms]
        cur_rows = cur[halo_ms - k_cmp: halo_ms]
        agree = np.median(np.sign(prev_rows) * np.sign(cur_rows), axis=0)
        flip[s] = flip[s - 1] * np.where(agree < 0, -1.0, 1.0)

    fields = {}
    for f in _REC_FIELDS:
        a = getattr(rec, f)                    # (seg_ms+halo, N·D, ...)
        parts = []
        for s in range(n_segments):
            lo = 0 if s == 0 else halo_ms
            cols = a[lo:lo + seg_ms, s * n:(s + 1) * n]
            if f == "corr":
                cols = cols * flip[s][None, :, None, None]
            parts.append(cols)
        fields[f] = np.concatenate(parts)[:n_ms]
    return TrackRecords(**fields, i_early=params.i_early,
                        i_prompt=params.i_prompt, i_late=params.i_late)
