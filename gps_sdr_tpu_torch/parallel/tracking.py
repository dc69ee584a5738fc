"""Channel-sharded conventional tracking.

Channels are independent between measurement epochs, so the channel axis
shards cleanly over ranks: each rank tracks its slice against its own
chunk of the capture, and the records are gathered in rank order.  The
counterpart of the JAX package's `gps_sdr_tpu/parallel/tracking.py`.

`tracking.run_tracking(..., mesh=...)` is the entry: it pads the channel
axis to a multiple of the world's size with duplicates of channel 0
(appended last, tracked like any channel, cut from the gathered records),
gives each rank its slice, and runs every chunk through `sharded_tracker`.
A channel's arithmetic does not depend on how many channels share its
launch (the kernels and their plain versions work channel by channel), so
the gathered records are bit for bit those of the unsharded run at any
world size.
"""

from __future__ import annotations

import torch

from gps_sdr_tpu_torch.parallel.mesh import Mesh
from gps_sdr_tpu_torch.tracking import _REC_FIELDS, TrackState


def grow(t: torch.Tensor, pad: int) -> torch.Tensor:
    """`t` with `pad` duplicates of its row 0 appended."""
    return torch.cat([t, t[:1].expand(pad, *t.shape[1:])])


def pad_channels(state: TrackState, chip_tables: torch.Tensor, mult: int):
    """Pad the channel axis of (state, chip_tables) to a multiple of
    `mult` with duplicates of channel 0, appended last.  Returns (state,
    tables, n_pad)."""
    pad = (-state.ptr.shape[0]) % mult
    if pad == 0:
        return state, chip_tables, 0
    return (TrackState(*[grow(f, pad) for f in state]),
            grow(chip_tables, pad), pad)


def shard_channels(mesh: Mesh, state: TrackState, chip_tables: torch.Tensor):
    """This rank's rows of a padded (state, chip_tables)."""
    rows = mesh.rows(state.ptr.shape[0])
    return TrackState(*[f[rows] for f in state]), chip_tables[rows]


def sharded_tracker(mesh: Mesh, tracker, n_real: int):
    """`tracker` (`track_chunk` or `track_scan`, as `run_tracking` chose
    it) over this rank's channel slice; returns fn(raw, chunk_start,
    state, chips, spec, n_steps) → (records of all `n_real` channels,
    gathered in rank order, with the world's fault flag; this rank's new
    state)."""

    def run(raw, chunk_start, state, chips, spec, n_steps):
        rec, state = tracker(raw, chunk_start, state, chips, spec, n_steps)
        out = {f: mesh.all_gather_rows(rec[f], n_real, dim=1)
               for f in _REC_FIELDS}
        out["fault"] = mesh.gather_fault(rec["fault"], state.ptr.shape[0])
        return out, state

    return run


def gather_state(mesh: Mesh, state: TrackState, n_real: int) -> TrackState:
    """The state of all `n_real` channels from every rank's slice."""
    return TrackState(*[mesh.all_gather_rows(f, n_real) for f in state])
