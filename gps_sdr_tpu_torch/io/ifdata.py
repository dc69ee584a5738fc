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
to float happens on the device (inside the tracking kernel).
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
        v = self.read_values(start_sample, n_samples)
        if self.cfg.data_type == 2:
            return v.reshape(-1, 2)
        return np.stack([v, np.zeros_like(v)], axis=-1)


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

    On a CUDA device each chunk is copied into one of two pinned host
    buffers and sent with `non_blocking=True`; a buffer is reused only
    after the copy that read it has completed (an event per buffer), so
    the host can fill the next chunk while the card works.  On the CPU the
    chunk is wrapped as it is."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._bufs = [None, None]
        self._events = [None, None]
        self._next = 0

    def stage(self, values: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(values))
        if self.device.type != "cuda":
            return host.to(self.device)
        i = self._next
        self._next ^= 1
        if self._events[i] is not None:
            self._events[i].synchronize()
        buf = self._bufs[i]
        if buf is None or buf.dtype != host.dtype or buf.numel() < host.numel():
            buf = torch.empty(int(host.numel() * 1.25) + 1, dtype=host.dtype,
                              pin_memory=True)
            self._bufs[i] = buf
        pinned = buf[:host.numel()].view(host.shape)
        pinned.copy_(host)
        out = pinned.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._events[i] = ev
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
