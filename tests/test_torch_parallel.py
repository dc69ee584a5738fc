"""The port's mesh layer (`gps_sdr_tpu_torch/parallel/`) in one process.

- `pad_channels` and `pad_vt_state` against the JAX package's on the same
  numpy inputs: equal.
- A world of one rank (gloo, a file store under pytest's tmp directory):
  the collectives; `sharded_acquisition_power` bit for bit the unsharded
  grid; `make_epoch_solver` bit for bit the same normal equations without a
  mesh, and within tests/test_mesh_pipeline.py's tolerances (position 1e-6
  m, DOP 1e-9, velocity and drift 1e-8) of the port's host solver and of
  the JAX package's sharded solver on the 8-device CPU mesh that
  tests/conftest.py sets up; the JAX package's sharded grid against the
  port's at the port's acquisition parity (tests/test_torch_acquisition.py).
- `mesh="auto"` is None without a world and in a world of one rank.

The worlds of 2 and 3 ranks are tests/test_torch_distributed.py's.
"""

import dataclasses
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gps_sdr_tpu_torch import convert
from gps_sdr_tpu_torch.config import L1_WAVELENGTH
from gps_sdr_tpu_torch.geo.ephemeris import Ephemeris as TEphemeris
from gps_sdr_tpu_torch.parallel import distributed as tdist
from gps_sdr_tpu_torch.parallel import mesh as tmesh
from gps_sdr_tpu_torch.parallel.acquisition import sharded_acquisition_power
from gps_sdr_tpu_torch.parallel.epoch import make_epoch_solver
from gps_sdr_tpu_torch.parallel.tracking import pad_channels
from gps_sdr_tpu_torch.parallel.vt import pad_vt_state
from gps_sdr_tpu_torch.tracking import TrackState

torch.set_num_threads(2)


def test_auto_mesh_is_none_without_a_world():
    """Runs first in this file, before the world of one rank exists."""
    assert not dist.is_initialized()
    assert tmesh.resolve_mesh("auto", "cpu") is None
    assert tmesh.resolve_mesh(None) is None
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="'auto'"):
        tmesh.resolve_mesh("all")


@pytest.mark.parametrize("n,mult", [(5, 2), (5, 3), (8, 3), (4, 4), (1, 8)])
def test_pad_channels_matches_jax(n, mult):
    from gps_sdr_tpu.parallel.tracking import pad_channels as jpad
    from gps_sdr_tpu.tracking import TrackState as JState

    rng = np.random.default_rng(n * 10 + mult)
    fields = {f: (rng.integers(0, 1 << 20, n) if f in ("ptr", "phase_fp")
                  else rng.normal(size=n)) for f in TrackState._fields}
    tables = rng.normal(size=(n, 1023)).astype(np.float32)
    jst, jtab, jpad_n = jpad(JState(**{k: jnp.asarray(v)
                                       for k, v in fields.items()}),
                             jnp.asarray(tables), mult)
    tst, ttab, tpad_n = pad_channels(
        TrackState(**{k: torch.as_tensor(v) for k, v in fields.items()}),
        torch.as_tensor(tables), mult)
    assert tpad_n == jpad_n == (-n) % mult
    np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab))
    for f in TrackState._fields:
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)


@pytest.mark.parametrize("n,mult", [(5, 2), (5, 3), (8, 3), (6, 3)])
def test_pad_vt_state_matches_jax(n, mult):
    """The JAX package's VT fixture (parallel/distributed._vt_fixture),
    padded by both packages: the replicated EKF fields untouched, the
    per-channel ones with duplicates of channel 0 appended."""
    from gps_sdr_tpu.parallel.distributed import _vt_fixture
    from gps_sdr_tpu.parallel.vt import pad_vt_state as jpad

    _, _, jst, jeph, jtab, _, _, _ = _vt_fixture(n)
    jst2, jtab2, jeph2, jpad_n = jpad(jst, jnp.asarray(jtab), jeph, mult)
    teph = TEphemeris(*[torch.as_tensor(np.array(f)) for f in jeph])
    tst2, ttab2, teph2, tpad_n = pad_vt_state(
        convert.vt_state_from_jax(jst, "cpu"), torch.as_tensor(jtab), teph,
        mult)
    assert tpad_n == jpad_n == (-n) % mult
    np.testing.assert_array_equal(ttab2.numpy(), np.asarray(jtab2))
    for a, b in zip(teph2, jeph2):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = convert.vt_state_to_numpy(tst2)
    for f, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jst2, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A torch.distributed world of one rank (gloo, file store) and its
    mesh on the CPU; destroyed after the module."""
    store = tmp_path_factory.mktemp("world1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    yield tmesh.make_mesh(device="cpu")
    dist.destroy_process_group()


def test_world_of_one(world1):
    """The mesh of a world of one rank and its collectives: the gather is
    the tensor itself (bool kept), the reduction too, the fault flag keeps
    its channel; "auto" stays None (one rank)."""
    assert (world1.rank, world1.size, world1.backend) == (0, 1, "gloo")
    assert world1.axis == tmesh.AXIS == "dev"
    assert world1.rows(6) == slice(0, 6)
    t = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    assert torch.equal(world1.all_gather_rows(t), t)
    assert torch.equal(world1.all_gather_rows(t, 2, dim=1), t[:, :2])
    flags = torch.tensor([True, False, True])
    out = world1.all_gather_rows(flags)
    assert out.dtype == torch.bool and torch.equal(out, flags)
    assert torch.equal(world1.reduce_sum(t), t)
    fault = torch.tensor([3], dtype=torch.int32)
    assert torch.equal(world1.gather_fault(fault, 4), fault)
    assert tmesh.resolve_mesh("auto", "cpu") is None
    with pytest.raises(ValueError, match="world has 1"):
        tmesh.make_mesh(n_devices=2, device="cpu")


def _acq_inputs(n_prn=11, n_freq=5, s=300, seed=2):
    rng = np.random.default_rng(seed)

    def c(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
                ).astype(np.complex64)

    return c(3, s), c(n_freq, s), c(n_prn, s)


def test_sharded_acquisition_power(world1):
    """11 PRNs in chunks of 4 (the last one short): the world of one rank's
    grid equals the unsharded grid bit for bit; the JAX package's sharded
    grid on its 8-device mesh (11 PRNs padded to 16) agrees within the
    port's acquisition parity (relative 1e-5 of the peak)."""
    from gps_sdr_tpu.acquisition import acquisition_power_grid as jgrid
    from gps_sdr_tpu.parallel.acquisition import (
        sharded_acquisition_power as jsharded)
    from gps_sdr_tpu.parallel.mesh import make_mesh as jmesh
    from gps_sdr_tpu_torch.acquisition import acquisition_power_grid

    blocks, carriers, code_fft = _acq_inputs()
    args = [torch.as_tensor(a) for a in (blocks, carriers, code_fft)]
    got = sharded_acquisition_power(world1, prn_chunk=4)(*args)
    ref = acquisition_power_grid(*args, prn_chunk=4)
    assert got.shape == (11, 5, 300) and got.dtype == torch.float32
    assert torch.equal(got, ref)
    assert len(jax.devices()) == 8
    jout = np.asarray(jsharded(jmesh(8), prn_chunk=4)(
        jnp.asarray(blocks), jnp.asarray(carriers), jnp.asarray(code_fft)))
    assert jout.shape == (11, 5, 300)
    np.testing.assert_allclose(
        jout, np.asarray(jgrid(jnp.asarray(blocks), jnp.asarray(carriers),
                               jnp.asarray(code_fft), prn_chunk=4)),
        rtol=0, atol=1e-6 * jout.max())
    np.testing.assert_allclose(got.numpy(), jout, rtol=0,
                               atol=1e-5 * jout.max())


def test_run_acquisition_power_hook(world1, tmp_path):
    """`run_acquisition(power_fn=…)` with the sharded grid finds what the
    default grid finds, bit for bit."""
    from gps_sdr_tpu_torch.acquisition import run_acquisition
    from gps_sdr_tpu_torch.io.ifdata import IFSampleSource

    path = str(tmp_path / "cap.bin")
    tdist.write_ingest_capture(path)
    cfg = tdist._small_cfg()
    cfg = cfg.replace(acq=dataclasses.replace(cfg.acq, prn_list=(7, 21, 3)))
    src = IFSampleSource(path, cfg.file)
    a = run_acquisition(src, cfg, device="cpu")
    b = run_acquisition(src, cfg, device="cpu",
                        power_fn=sharded_acquisition_power(world1))
    assert list(a.sv) == [7, 21]
    for f in ("sv", "snr_db", "doppler_hz", "code_delay", "fine_freq_hz"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_epoch_solver(world1):
    """tests/test_mesh_pipeline.py's masked epoch: the world of one rank's
    solver equals the same normal equations without a mesh bit for bit,
    and agrees with the port's host solver and the JAX package's sharded
    solver (8-device mesh, 6 channels padded to 8) within that test's
    tolerances."""
    from gps_sdr_tpu.parallel.epoch import make_epoch_solver as jsolver
    from gps_sdr_tpu.parallel.mesh import make_mesh as jmesh
    from gps_sdr_tpu_torch.positioning.wls import (doppler_velocity_ls,
                                                   iterated_ls_position)

    fx = tdist.epoch_fixture()
    args = (fx["pr"], fx["sv"], fx["sv_vel"], fx["doppler"], fx["clk_rate"],
            fx["valid"], fx["init"])
    got = make_epoch_solver(world1, L1_WAVELENGTH)(*args)
    alone = make_epoch_solver(None, L1_WAVELENGTH, device="cpu")(*args)
    for a, b in zip(got[:3], alone[:3]):
        assert a.dtype == torch.float64 and torch.equal(a, b)
    assert got[3] == alone[3]
    v = fx["valid"]
    est_h, dop_h = iterated_ls_position(fx["pr"][v], fx["sv"][v], fx["init"])
    vel_h, drift_h, _ = doppler_velocity_ls(
        est_h[:3], fx["sv"][v], fx["sv_vel"][v], fx["doppler"][v],
        L1_WAVELENGTH, fx["clk_rate"][v])
    j = jsolver(jmesh(8), L1_WAVELENGTH)(*args)
    for ref in ((est_h.numpy(), dop_h.numpy(), vel_h.numpy(), float(drift_h)),
                tuple(np.asarray(x) for x in j)):
        np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=0, atol=1e-9)
        np.testing.assert_allclose(got[2].numpy(), ref[2], rtol=0, atol=1e-8)
        assert abs(got[3] - float(ref[3])) <= 1e-8


def test_epoch_masked_row_is_a_no_op(world1):
    """A gated-out channel changes nothing: the solve over all rows with
    its weight 0 equals the solve without the row, to float64 round-off."""
    fx = tdist.epoch_fixture()
    v = fx["valid"]
    keep = np.nonzero(v)[0]
    solver = make_epoch_solver(world1, L1_WAVELENGTH)
    full = solver(fx["pr"], fx["sv"], fx["sv_vel"], fx["doppler"],
                  fx["clk_rate"], v, fx["init"])
    part = solver(fx["pr"][keep], fx["sv"][keep], fx["sv_vel"][keep],
                  fx["doppler"][keep], fx["clk_rate"][keep], v[keep],
                  fx["init"])
    for a, b in zip(full[:3], part[:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-9)
