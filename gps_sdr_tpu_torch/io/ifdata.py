"""IF capture-file ingest and host→device staging.

One memory-mapped (or in-memory) view of the capture; stages read
fixed-size windows by absolute sample index.  Formats match
`initParameters.m:37-38` and the read paths of `acquisition.m:27-38`:

  data_type=2, precision=1  int8 interleaved IQ  (Opensky / NSL STEREO)
  data_type=2, precision=2  int16 interleaved IQ (Urban; per-block DC removal)
  data_type=1               real-only samples

Complex convention (acquisition.m:36): sample = v[0] + 1j·v[1].

Staging contract: the host ships the native int8/int16 pairs; they cross
to the card from a pinned buffer with `non_blocking=True`, and the cast
to float happens on the device (inside the tracking kernel).  A stage whose
channels lie far apart in the capture (time-segmented tracking) holds the
whole capture on the card instead (`upload_capture`), uploaded once through
a pinned buffer of bounded size.  `ChunkFeed` is the one place a tracking
call's chunks are windowed, read ahead and staged: on the card each chunk
is read straight into one of two pinned buffers, used again chunk after
chunk, and sent to the card from there, so a chunk crosses host memory
once.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from gps_sdr_tpu_torch.config import FileConfig
from gps_sdr_tpu_torch.utils.spans import span


class IFSampleSource:
    """Random-access view of an IF capture; sample indices are absolute
    complex-sample (or real-sample for data_type=1) positions."""

    def __init__(self, path: str, file_cfg: FileConfig):
        self.cfg = file_cfg
        dtype = np.int8 if file_cfg.data_precision == 1 else np.int16
        # copy-on-write, so torch takes the map as it is (nothing writes)
        self._raw = np.memmap(path, dtype=dtype, mode="c")
        self.n_samples = self._raw.size // file_cfg.values_per_sample

    @classmethod
    def from_array(cls, values: np.ndarray, file_cfg: FileConfig
                   ) -> "IFSampleSource":
        """Wrap an in-memory interleaved value array."""
        obj = cls.__new__(cls)
        obj.cfg = file_cfg
        obj._raw = np.ascontiguousarray(values)
        obj.n_samples = obj._raw.size // file_cfg.values_per_sample
        return obj

    def read_values(self, start_sample: int, n_samples: int) -> np.ndarray:
        """Raw interleaved values for [start, start+n) samples, zero-padded."""
        vps = self.cfg.values_per_sample
        v0 = start_sample * vps
        v1 = v0 + n_samples * vps
        lo = max(v0, 0)
        hi = min(v1, self._raw.size)
        out = np.zeros(n_samples * vps, dtype=self._raw.dtype)
        if hi > lo:
            out[lo - v0: hi - v0] = self._raw[lo:hi]
        return out

    def read_complex(self, start_sample: int, n_samples: int,
                     remove_dc: Optional[bool] = None) -> np.ndarray:
        """Complex64 samples [start, start+n); int16 captures get per-block
        mean removal by default (acquisition.m:29-32)."""
        v = self.read_values(start_sample, n_samples).astype(np.float32)
        if self.cfg.data_type == 2:
            i, q = v[0::2], v[1::2]
        else:
            i, q = v, np.zeros_like(v)
        if remove_dc is None:
            remove_dc = self.cfg.data_precision == 2
        if remove_dc:
            i = i - i.mean()
            q = q - q.mean()
        return (i + 1j * q).astype(np.complex64)

    def read_iq_values(self, start_sample: int, n_samples: int
                       ) -> np.ndarray:
        """(n, 2) raw int8/int16 IQ values — the staging payload; the cast
        happens on the device."""
        out = np.empty((n_samples, 2), dtype=self._raw.dtype)
        self.read_iq_into(start_sample, out)
        return out

    def read_iq_into(self, start_sample: int, out) -> None:
        """Fill `out`, an (n, 2) array or CPU tensor of the capture's
        dtype, with the IQ values of samples [start, start+n) (zeros
        outside the capture), without an intermediate copy.  Torch copies
        them on its intra-op threads, faster on a host of several cores
        than numpy's copy on one."""
        dst = torch.as_tensor(out)
        n = dst.shape[0]
        lo = min(max(start_sample, 0), start_sample + n)
        hi = max(min(start_sample + n, self.n_samples), lo)
        dst[:lo - start_sample] = 0
        dst[hi - start_sample:] = 0
        inner = dst[lo - start_sample:hi - start_sample]
        if self.cfg.data_type == 2:
            inner.view(-1).copy_(torch.from_numpy(self._raw[2 * lo:2 * hi]))
        else:
            inner[:, 0].copy_(torch.from_numpy(self._raw[lo:hi]))
            inner[:, 1] = 0


class PinnedRing:
    """Two pinned host buffers, handed out in turn, for host→device copies
    with `non_blocking=True`: `take` hands a buffer out again only after
    the copy that last read it has completed (the event `sent` recorded
    for it; the wait is the span `io.ring_wait`), so the host can fill one
    while the card reads the other.  A buffer grows to `slack` times the
    largest piece asked of it.  One thread may take and fill a buffer
    while another sends the one filled before: `take` touches only the
    buffer it hands out, `sent` only its piece's (found by its storage)."""

    def __init__(self, device: torch.device, slack: float = 1.0):
        self.device = torch.device(device)
        self.slack = slack
        self._bufs = [None, None]
        self._events = [None, None]
        self._next = 0

    def take(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A pinned host tensor of `shape` at the head of the next buffer,
        free to be filled; pass it, or a piece of it, to `sent` once its
        copy to the device is queued."""
        i = self._next
        self._next ^= 1
        if self._events[i] is not None:
            with span("io.ring_wait"):
                self._events[i].synchronize()
        n = int(np.prod(shape))
        buf = self._bufs[i]
        if buf is None or buf.dtype != dtype or buf.numel() < n:
            buf = torch.empty(int(n * self.slack) + 1, dtype=dtype,
                              pin_memory=True)
            self._bufs[i] = buf
        return buf[:n].view(shape)

    def sent(self, piece: torch.Tensor) -> None:
        """The copy from `piece`, a tensor `take` gave or a piece of one,
        is queued: record its buffer's event."""
        ptr = piece.untyped_storage().data_ptr()
        i = next(i for i, buf in enumerate(self._bufs) if buf is not None
                 and buf.untyped_storage().data_ptr() == ptr)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._events[i] = ev


# pinned host memory of a resident upload: two pieces of this many bytes
UPLOAD_PIECE_BYTES = 128 << 20


def _iq_dtype(source: IFSampleSource) -> torch.dtype:
    return torch.int8 if source.cfg.data_precision == 1 else torch.int16


def read_pinned(ring: PinnedRing, source: IFSampleSource, start: int,
                n: int) -> torch.Tensor:
    """Samples [start, start+n) of `source` as (n, 2) raw IQ values, read
    straight into the next buffer of `ring` (`read_iq_into`)."""
    host = ring.take((n, 2), _iq_dtype(source))
    source.read_iq_into(start, host)
    return host


def upload_capture(source: IFSampleSource, device) -> torch.Tensor:
    """The whole capture as one (n_samples, 2) int8/int16 tensor on
    `device`, row s holding sample s.

    On a CUDA device the tensor is allocated once and filled piece by
    piece: each piece of `UPLOAD_PIECE_BYTES` is read straight into a
    buffer of a `PinnedRing` and copied with `non_blocking=True`, so the
    pinned memory stays at 2 × 128 MiB whatever the capture's size.
    Returns after the last copy.  On the CPU it is the capture's values as
    a CPU tensor."""
    device = torch.device(device)
    n = source.n_samples
    if device.type != "cuda":
        return torch.from_numpy(source.read_iq_values(0, n)).to(device)
    out = torch.empty((n, 2), dtype=_iq_dtype(source), device=device)
    rows = max(1, UPLOAD_PIECE_BYTES // (2 * out.element_size()))
    ring = PinnedRing(device)
    for lo in range(0, n, rows):
        host = read_pinned(ring, source, lo, min(rows, n - lo))
        out[lo:lo + host.shape[0]].copy_(host, non_blocking=True)
        ring.sent(host)
    torch.cuda.current_stream(device).synchronize()
    return out


class ChunkPrefetcher:
    """Overlap the next chunk's host read with the caller's work on the
    current one.

    `fetch(start, n, then)` returns samples [start, start+n), sliced from
    the pending read when it holds them (a miss reads inline), and before
    returning submits the read of `then`, the next chunk's (start, n), to
    a thread of its own: that read runs while the caller stages the
    chunk, issues its tracker and waits for its records.  The view
    `fetch` returns lies in what `read_fn` returned: for
    `source.read_iq_values` an array of its own; for `DeviceStager.read`
    on a CUDA device a buffer of a two-buffer `PinnedRing`, which the
    read the next fetch submits fills again (for the fetch after next)
    once the copy that last read it has completed.  So such a view holds
    until the next fetch, and a copy of it queued before then reads it
    whole.  The span
    `io.fetch` is the caller's wait,
    `io.read` each read (on the prefetch thread, or inside `io.fetch` on
    a miss)."""

    def __init__(self, read_fn):
        self._read_fn = read_fn
        self._pool = ThreadPoolExecutor(1)
        self._pending = None       # (start, n, future)

    def _read(self, start: int, n: int):
        with span("io.read", n):
            return self._read_fn(start, n)

    def _submit(self, start: int, n: int) -> None:
        self._pending = (start, n, self._pool.submit(self._read, start, n))

    def fetch(self, start: int, n: int,
              then: Optional[Tuple[int, int]] = None):
        with span("io.fetch", n):
            arr = None
            if self._pending is not None:
                p_start, p_n, fut = self._pending
                self._pending = None
                got = fut.result()
                if p_start <= start and start + n <= p_start + p_n:
                    arr = got[start - p_start:start - p_start + n]
            if arr is None:
                arr = self._read(start, n)
            if then is not None:
                self._submit(*then)
            return arr

    def close(self) -> None:
        if self._pending is not None:
            self._pending[2].result()
            self._pending = None
        self._pool.shutdown(wait=True)


class DeviceStager:
    """Host→device staging of raw IQ chunks: `stage(read(source, start,
    n))`.

    On a CUDA device `read` fills the next buffer of the stager's
    `PinnedRing` (grown with a quarter of slack, as chunk windows vary a
    little; a refill waits for the copy that last read the buffer), and
    `stage` sends what `read` gave, or a piece of it, from that buffer
    with `non_blocking=True` (span `io.pinned`, n its bytes) and records
    the buffer's event, so the host can fill the other buffer while the
    card works; each chunk comes back as a device tensor of its own.  On
    the CPU `read` returns an array of its own and `stage` wraps it."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._ring = PinnedRing(self.device, slack=1.25)

    def read(self, source: IFSampleSource, start: int, n: int):
        """Samples [start, start+n) of `source` as (n, 2) raw IQ values,
        to be staged."""
        if self.device.type != "cuda":
            return source.read_iq_values(start, n)
        return read_pinned(self._ring, source, start, n)

    def stage(self, values) -> torch.Tensor:
        with span("io.stage", values.nbytes):
            if self.device.type != "cuda":
                return torch.from_numpy(
                    np.ascontiguousarray(values)).to(self.device)
            with span("io.pinned", values.nbytes):
                out = values.to(self.device, non_blocking=True)
                self._ring.sent(values)
            return out


# the read-ahead's margin each side of the next chunk's window, for the
# pointers' code-Doppler drift over a chunk [ms]
DRIFT_MARGIN_MS = 2


class ChunkFeed:
    """The chunks of one tracking call on its device: the one place they
    are windowed, read ahead and staged.

    `next(ptr, nb, nb_next)` gives `(raw, chunk_start)`: the samples from
    the first of the pointers `ptr` to the last plus `window.need(nb)`
    (`ops.track_chunk.ChunkWindow`), fetched through a `ChunkPrefetcher`
    and staged through a `DeviceStager`.  The fetch submits the read of
    the next chunk, `nb_next` blocks (none when 0), from the current
    pointers alone and `DRIFT_MARGIN_MS` wider each side than it needs,
    so only a call's first fetch reads inline.  Every read, ahead or
    inline, is the stager's `read`: on a CUDA device it goes straight
    into the next buffer of the stager's pinned ring (a refill waits on
    the prefetch thread for the copy that last read the buffer), and the
    stager sends the chunk from there: the pinned memory is the ring's two
    buffers, and no chunk is copied on the host again.  With `resident` (the
    capture on the device, `upload_capture`) every chunk is that tensor
    from sample 0, with no read and no staging.  `slack`, the two margins,
    is the room a `tracking.ScanGraph` buffer adds to its first window."""

    def __init__(self, source: IFSampleSource, device, window,
                 resident: Optional[torch.Tensor] = None):
        device = torch.device(device)
        if resident is not None and (resident.device != device
                                     or resident.shape[0] != source.n_samples):
            raise ValueError(
                f"resident capture {tuple(resident.shape)} on "
                f"{resident.device} is not the {source.n_samples}-sample "
                f"capture on {device}")
        self.window, self.resident = window, resident
        self._margin = DRIFT_MARGIN_MS * window.samples_per_ms
        self.slack = 2 * self._margin
        if resident is None:
            self._stager = DeviceStager(device)
            self._prefetcher = ChunkPrefetcher(
                partial(self._stager.read, source))

    def next(self, ptr: torch.Tensor, nb: int, nb_next: int
             ) -> Tuple[torch.Tensor, int]:
        if self.resident is not None:
            return self.resident, 0
        ptrs = ptr.cpu()
        lo, hi = int(ptrs.min()), int(ptrs.max())
        then = ((lo + nb * self.window.step - self._margin,
                 hi - lo + self.window.need(nb_next) + self.slack)
                if nb_next > 0 else None)
        values = self._prefetcher.fetch(lo, hi - lo + self.window.need(nb),
                                        then)
        return self._stager.stage(values), lo

    def close(self) -> None:
        if self.resident is None:
            self._prefetcher.close()


def write_if_file(path: str, iq: np.ndarray, file_cfg: FileConfig) -> None:
    """Write complex samples as an interleaved capture file (int8 or int16
    by `file_cfg.data_precision`; real part only when data_type = 1)."""
    dtype = np.int8 if file_cfg.data_precision == 1 else np.int16
    info = np.iinfo(dtype)
    iq = np.asarray(iq)
    if file_cfg.data_type == 2:
        vals = np.empty(2 * iq.size, dtype=np.float64)
        vals[0::2] = iq.real
        vals[1::2] = iq.imag
    else:
        vals = iq.real.astype(np.float64)
    np.clip(np.round(vals), info.min, info.max).astype(dtype).tofile(path)
