"""Channel-sharded vector tracking (VDFLL).

The VT loop couples all channels every ms through the 8-state EKF
(trackingVT_POS_updated.m:388-404), but the coupling is small: each channel
gives one line-of-sight row at the Kepler group head, and two measurements
and a validity bit a ms.  Everything else (the correlator bank, the code and
carrier NCOs, the scalar PLLs, Kepler, the atmosphere) is per channel and
shards over ranks.  The counterpart of the JAX package's
`gps_sdr_tpu/parallel/vt.py`.

`receiver/vt.run_vector_tracking(..., mesh=...)` is the entry: the channel
axis of the state, the code tables and the ephemeris is padded to a
multiple of the world's size, each rank scans its slice, and every rank
applies the same EKF update from the gathered rows (`receiver/vt.py` says
which rows, and when).  The gather does not change a row's bits, so the
records are those of the unsharded scan.
"""

from __future__ import annotations

import torch

from gps_sdr_tpu_torch.geo.ephemeris import Ephemeris
from gps_sdr_tpu_torch.parallel.mesh import Mesh
from gps_sdr_tpu_torch.parallel.tracking import grow
from gps_sdr_tpu_torch.receiver.vt import (_VT_STATE_REPLICATED, VTState,
                                           vt_scan)


def pad_vt_state(state: VTState, chip_tables: torch.Tensor, eph: Ephemeris,
                 mult: int):
    """Pad the channel axis of (state, chip_tables, eph) to a multiple of
    `mult` with duplicates of channel 0, appended last (so the gathers'
    cut to the real channels never sees them); the replicated EKF fields
    are left as they are.  Returns (state, tables, eph, n_pad)."""
    pad = (-state.ptr.shape[0]) % mult
    if pad == 0:
        return state, chip_tables, eph, 0
    state = VTState(**{
        f: v if f in _VT_STATE_REPLICATED else grow(v, pad)
        for f, v in state._asdict().items()})
    return (state, grow(chip_tables, pad),
            Ephemeris(*[grow(f, pad) for f in eph]), pad)


def shard_vt_state(mesh: Mesh, state: VTState, chip_tables: torch.Tensor,
                   eph: Ephemeris):
    """This rank's rows of a padded (state, chip_tables, eph); the
    replicated EKF fields whole."""
    rows = mesh.rows(state.ptr.shape[0])
    state = VTState(**{f: v if f in _VT_STATE_REPLICATED else v[rows]
                       for f, v in state._asdict().items()})
    return state, chip_tables[rows], Ephemeris(*[f[rows] for f in eph])


def sharded_vt_scan(mesh: Mesh, n_real: int):
    """`vt_scan` with this rank's slice of a world of `n_real` real
    channels: the same arguments, the world's records, this rank's state
    (see `vt_scan`'s `mesh`)."""

    def scan(*args, **kw):
        return vt_scan(*args, mesh=mesh, n_real=n_real, **kw)

    return scan


def gather_vt_state(mesh: Mesh, state: VTState, n_real: int) -> VTState:
    """The state of all `n_real` channels from every rank's slice."""
    return VTState(**{
        f: v if f in _VT_STATE_REPLICATED else mesh.all_gather_rows(v, n_real)
        for f, v in state._asdict().items()})
