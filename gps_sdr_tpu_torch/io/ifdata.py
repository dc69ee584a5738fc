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
a pinned buffer of bounded size.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from gps_sdr_tpu_torch.config import FileConfig


class IFSampleSource:
    """Random-access view of an IF capture; sample indices are absolute
    complex-sample (or real-sample for data_type=1) positions."""

    def __init__(self, path: str, file_cfg: FileConfig):
        self.cfg = file_cfg
        dtype = np.int8 if file_cfg.data_precision == 1 else np.int16
        self._raw = np.memmap(path, dtype=dtype, mode="r")
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

    def read_iq_into(self, start_sample: int, out: np.ndarray) -> None:
        """Fill `out`, an (n, 2) array of the capture's dtype, with the IQ
        values of samples [start, start+n) (zeros outside the capture),
        without an intermediate copy."""
        n = out.shape[0]
        lo = min(max(start_sample, 0), start_sample + n)
        hi = max(min(start_sample + n, self.n_samples), lo)
        out[:lo - start_sample] = 0
        out[hi - start_sample:] = 0
        inner = out[lo - start_sample:hi - start_sample]
        if self.cfg.data_type == 2:
            inner.reshape(-1)[:] = self._raw[2 * lo:2 * hi]
        else:
            inner[:, 0] = self._raw[lo:hi]
            inner[:, 1] = 0


class PinnedRing:
    """Two pinned host buffers, handed out in turn, for host→device copies
    with `non_blocking=True`: a buffer is handed out again only after the
    copy that read it has completed (an event per buffer), so the host can
    fill one while the card reads the other.  A buffer grows to `slack`
    times the largest piece asked of it."""

    def __init__(self, device: torch.device, slack: float = 1.0):
        self.device = torch.device(device)
        self.slack = slack
        self._bufs = [None, None]
        self._events = [None, None]
        self._next = 0

    def take(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A pinned host tensor of `shape`, free to be filled; pass it to
        `sent` once its copy to the device is queued."""
        i = self._next
        if self._events[i] is not None:
            self._events[i].synchronize()
        n = int(np.prod(shape))
        buf = self._bufs[i]
        if buf is None or buf.dtype != dtype or buf.numel() < n:
            buf = torch.empty(int(n * self.slack) + 1, dtype=dtype,
                              pin_memory=True)
            self._bufs[i] = buf
        return buf[:n].view(shape)

    def sent(self) -> None:
        """The copy from the buffer `take` last gave is queued: record its
        event and move to the other buffer."""
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._events[self._next] = ev
        self._next ^= 1


# pinned host memory of a resident upload: two pieces of this many bytes
UPLOAD_PIECE_BYTES = 128 << 20


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
    dtype = torch.int8 if source.cfg.data_precision == 1 else torch.int16
    out = torch.empty((n, 2), dtype=dtype, device=device)
    rows = max(1, UPLOAD_PIECE_BYTES // (2 * out.element_size()))
    ring = PinnedRing(device)
    for lo in range(0, n, rows):
        host = ring.take((min(rows, n - lo), 2), dtype)
        source.read_iq_into(lo, host.numpy())
        out[lo:lo + host.shape[0]].copy_(host, non_blocking=True)
        ring.sent()
    torch.cuda.current_stream(device).synchronize()
    return out


class ChunkPrefetcher:
    """Overlap the next chunk's host read with the device's work on the
    current one.  `fetch` serves any window contained in the pending
    prefetch by slicing; a miss reads directly."""

    def __init__(self, read_fn):
        self._read = read_fn
        self._pool = ThreadPoolExecutor(1)
        self._pending = None       # (start, n, future)
        self.hits = 0
        self.misses = 0

    def prefetch(self, start: int, n: int) -> None:
        self._pending = (start, n, self._pool.submit(self._read, start, n))

    def fetch(self, start: int, n: int) -> np.ndarray:
        if self._pending is not None:
            p_start, p_n, fut = self._pending
            self._pending = None
            arr = fut.result()
            if p_start <= start and start + n <= p_start + p_n:
                self.hits += 1
                off = start - p_start
                return arr[off:off + n]
        self.misses += 1
        return self._read(start, n)

    def close(self) -> None:
        if self._pending is not None:
            self._pending[2].result()
            self._pending = None
        self._pool.shutdown(wait=True)


class DeviceStager:
    """Host→device staging of raw IQ chunks.

    On a CUDA device each chunk is copied into a buffer of a `PinnedRing`
    (grown with a quarter of slack, as chunk windows vary a little) and
    sent with `non_blocking=True`, so the host can fill the next chunk
    while the card works.  On the CPU the chunk is wrapped as it is."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._ring = PinnedRing(self.device, slack=1.25)

    def stage(self, values: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(values))
        if self.device.type != "cuda":
            return host.to(self.device)
        pinned = self._ring.take(host.shape, host.dtype)
        pinned.copy_(host)
        out = pinned.to(self.device, non_blocking=True)
        self._ring.sent()
        return out


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
