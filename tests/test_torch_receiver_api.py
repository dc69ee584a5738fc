"""The port's `Receiver` entry points against the JAX package's, on the CPU.

- `acquisition(power_fn=…)`: each `Receiver` given its own package's plain
  grid function (`acquisition_power_grid`), wrapped so that it counts its
  calls, over the same small int8 capture: the tables are equal (PRNs,
  code delays and Doppler bins exact, SNR within 1e-3 dB, as
  tests/test_torch_acquisition.py holds `run_acquisition`), each wrapper
  ran once, and a second call is served from the stage's result.
- Every public method of the JAX `Receiver` exists on the port's and takes
  every keyword its JAX counterpart takes (`inspect.signature`).
"""

import inspect

import numpy as np
import pytest
import torch

from gps_sdr_tpu.acquisition import acquisition_power_grid as j_grid
from gps_sdr_tpu.config import (AcqConfig, FileConfig, ReceiverConfig,
                                SignalConfig)
from gps_sdr_tpu.io.ifdata import IFSampleSource as JSource
from gps_sdr_tpu.io.synthetic import SyntheticSV, generate_if_samples
from gps_sdr_tpu.pipeline import Receiver as JReceiver
from gps_sdr_tpu_torch import convert
from gps_sdr_tpu_torch.acquisition import acquisition_power_grid as t_grid
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource as TSource
from gps_sdr_tpu_torch.pipeline import Receiver as TReceiver

torch.set_num_threads(2)

CFG = ReceiverConfig(
    file=FileConfig(name="rxapi", skip_ms=0),
    signal=SignalConfig(f_if=1.25e6, fs=4.1e6),
    acq=AcqConfig(prn_list=(1, 3, 5, 7, 11, 16, 22, 27)))
SVS = [SyntheticSV(prn=3, amplitude=2.0, doppler_hz=1750.0,
                   code_delay_samples=1234.5),
       SyntheticSV(prn=16, amplitude=1.6, doppler_hz=-3260.0,
                   code_delay_samples=77.25),
       SyntheticSV(prn=27, amplitude=1.2, doppler_hz=4420.0,
                   code_delay_samples=3900.0)]
PUBLIC = sorted(n for n, f in inspect.getmembers(JReceiver, callable)
                if not n.startswith("_"))


def _counted(fn):
    """`fn`, counting its calls in `.calls`."""
    def wrapped(*a, **k):
        wrapped.calls += 1
        return fn(*a, **k)
    wrapped.calls = 0
    return wrapped


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Both Receivers' acquisition tables, each from a counted grid
    function of its own package, with each receiver and wrapper."""
    iq = generate_if_samples(CFG, SVS, 40, noise_std=8.0, seed=3)
    vals = np.empty(2 * iq.size)
    vals[0::2], vals[1::2] = iq.real, iq.imag
    vals = np.clip(np.round(vals), -127, 127).astype(np.int8)
    tcfg = convert.config_from_jax(CFG)
    root = tmp_path_factory.mktemp("receiver_api")
    jfn, tfn = _counted(j_grid), _counted(t_grid)
    jrx = JReceiver(CFG, JSource.from_array(vals, CFG.file),
                    artifact_dir=str(root / "jax"), mesh=None)
    trx = TReceiver(tcfg, TSource.from_array(vals, tcfg.file),
                    artifact_dir=str(root / "torch"), device="cpu")
    return dict(ref=jrx.acquisition(power_fn=jfn),
                got=trx.acquisition(power_fn=tfn), jfn=jfn, tfn=tfn,
                jrx=jrx, trx=trx)


def test_acquisition_power_fn_gives_the_jax_table(tables):
    ref, got = tables["ref"], tables["got"]
    assert sorted(got.sv.tolist()) == [3, 16, 27]
    np.testing.assert_array_equal(got.sv, ref.sv)
    np.testing.assert_array_equal(got.code_delay, ref.code_delay)
    np.testing.assert_array_equal(got.doppler_hz, ref.doppler_hz)
    np.testing.assert_allclose(got.snr_db, ref.snr_db, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.fine_freq_hz, ref.fine_freq_hz)


def test_acquisition_calls_the_callers_power_fn_once(tables):
    """Each wrapper ran for its own Receiver's grid; a second call is the
    stage's result, with no grid computed again."""
    assert (tables["jfn"].calls, tables["tfn"].calls) == (1, 1)
    again = _counted(t_grid)
    assert tables["trx"].acquisition(power_fn=again) is tables["got"]
    assert again.calls == 0


def test_public_methods_listed():
    assert {"acquisition", "track_for_eph", "ct_position", "vt_position",
            "export_mat", "report"} <= set(PUBLIC)


@pytest.mark.parametrize("name", PUBLIC)
def test_port_method_takes_every_jax_keyword(name):
    """The port's method exists and takes each keyword of the JAX one (the
    port may add its own, as `device` on the constructor)."""
    assert hasattr(TReceiver, name), name
    want = inspect.signature(getattr(JReceiver, name)).parameters
    got = inspect.signature(getattr(TReceiver, name)).parameters
    missing = [k for k, p in want.items() if k not in got
               and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    assert not missing, (name, missing)


def test_constructor_takes_every_jax_keyword():
    want = inspect.signature(JReceiver.__init__).parameters
    got = inspect.signature(TReceiver.__init__).parameters
    assert set(want) <= set(got), sorted(set(want) - set(got))
