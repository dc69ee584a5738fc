"""State carried across: the JAX package's objects → the port's, and back
to numpy for comparison.

Every function takes the JAX-side object duck-typed (its fields read
through numpy), so this module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from gps_sdr_tpu_torch import config as cfg_mod
from gps_sdr_tpu_torch.acquisition import AcquisitionResult
from gps_sdr_tpu_torch.navdecode import EphemerisRecord
from gps_sdr_tpu_torch.receiver.ct import NavSolutions
from gps_sdr_tpu_torch.receiver.vt import (_VT_STATE_DTYPES, VTSolutions,
                                           VTState, VTTrackRecords)
from gps_sdr_tpu_torch.tracking import _REC_FIELDS, TrackRecords, TrackState
from gps_sdr_tpu_torch.utils.device import resolve_device

_CFG_PARTS = {"file": cfg_mod.FileConfig, "signal": cfg_mod.SignalConfig,
              "acq": cfg_mod.AcqConfig, "track": cfg_mod.TrackConfig,
              "solu": cfg_mod.SolutionConfig, "cmn": cfg_mod.CommonConfig}

_STATE_DTYPES = {"ptr": torch.int64, "phase_fp": torch.int32}


def _fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


def config_from_jax(cfg) -> cfg_mod.ReceiverConfig:
    """A JAX-package ReceiverConfig → the port's, field for field."""
    return cfg_mod.ReceiverConfig(**{
        part: cls(**{f: getattr(getattr(cfg, part), f) for f in _fields(cls)})
        for part, cls in _CFG_PARTS.items()})


def config_to_dict(cfg) -> Dict[str, dict]:
    """Either package's ReceiverConfig as plain nested dicts."""
    return {part: {f: getattr(getattr(cfg, part), f) for f in _fields(cls)}
            for part, cls in _CFG_PARTS.items()}


def acquisition_from_jax(acq) -> AcquisitionResult:
    return AcquisitionResult(**{f: np.array(getattr(acq, f))
                                for f in _fields(AcquisitionResult)})


def acquisition_to_numpy(acq) -> Dict[str, np.ndarray]:
    return {f: np.asarray(getattr(acq, f)) for f in _fields(AcquisitionResult)}


def track_state_from_jax(state, device=None) -> TrackState:
    """A JAX TrackState (jax arrays) → the port's, tensors on `device`
    (the card when None)."""
    device = resolve_device(device)
    return TrackState(**{
        f: torch.as_tensor(np.array(getattr(state, f)),
                           dtype=_STATE_DTYPES.get(f, torch.float64),
                           device=device)
        for f in TrackState._fields})


def _arr(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def track_state_to_numpy(state) -> Dict[str, np.ndarray]:
    return {f: _arr(getattr(state, f)) for f in TrackState._fields}


def vt_state_from_jax(state, device=None) -> VTState:
    """A JAX VTState (jax arrays) → the port's, tensors on `device` (the
    card when None); float fields become float64 (the port's `vt_scan`
    casts the covariance loop to float32 itself, as the JAX scan does)."""
    device = resolve_device(device)
    return VTState(**{
        f: torch.as_tensor(np.array(getattr(state, f)),
                           dtype=_VT_STATE_DTYPES.get(f, torch.float64),
                           device=device)
        for f in VTState._fields})


def vt_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Either package's VTState as numpy arrays."""
    return {f: _arr(getattr(state, f)) for f in VTState._fields}


def records_from_jax(rec) -> TrackRecords:
    return TrackRecords(**{f: np.array(getattr(rec, f)) for f in _REC_FIELDS},
                        i_early=int(rec.i_early), i_prompt=int(rec.i_prompt),
                        i_late=int(rec.i_late))


def records_to_numpy(rec) -> Dict[str, np.ndarray]:
    return {f: np.asarray(getattr(rec, f)) for f in _REC_FIELDS}


def _dataclass_from(cls, obj):
    return cls(**{f: (None if getattr(obj, f) is None
                      else np.array(getattr(obj, f))) for f in _fields(cls)})


def _dataclass_to_numpy(cls, obj) -> Dict[str, np.ndarray]:
    return {f: np.asarray(getattr(obj, f)) for f in _fields(cls)
            if getattr(obj, f) is not None}


def vt_records_from_jax(trk) -> VTTrackRecords:
    return _dataclass_from(VTTrackRecords, trk)


def vt_records_to_numpy(trk) -> Dict[str, np.ndarray]:
    return _dataclass_to_numpy(VTTrackRecords, trk)


def vt_solutions_from_jax(sol) -> VTSolutions:
    return _dataclass_from(VTSolutions, sol)


def vt_solutions_to_numpy(sol) -> Dict[str, np.ndarray]:
    return _dataclass_to_numpy(VTSolutions, sol)


def ephemeris_from_jax(eph: Dict[int, object], sbf: Dict[str, dict]
                       ) -> Tuple[Dict[int, EphemerisRecord], Dict[str, dict]]:
    """{prn: EphemerisRecord} + sbf{nav1, sfb1} → the port's."""
    out = {}
    for prn, rec in eph.items():
        vals = {f: getattr(rec, f) for f in _fields(EphemerisRecord)}
        out[int(prn)] = EphemerisRecord(**{
            f: (list(v) if isinstance(v, list) else v)
            for f, v in vals.items()})
    return out, {k: {int(p): int(v) for p, v in d.items()}
                 for k, d in sbf.items()}


def ephemeris_to_numpy(eph: Dict[int, object]) -> Dict[int, dict]:
    return {int(p): {f: (np.asarray(getattr(r, f))
                         if isinstance(getattr(r, f), list)
                         else getattr(r, f))
                     for f in _fields(EphemerisRecord)}
            for p, r in eph.items()}


def nav_from_jax(nav) -> NavSolutions:
    return _dataclass_from(NavSolutions, nav)


def nav_to_numpy(nav) -> Dict[str, np.ndarray]:
    return _dataclass_to_numpy(NavSolutions, nav)
