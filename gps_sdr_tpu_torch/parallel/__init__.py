"""Parallel paths: time-segmented (overlap-save) tracking on one device,
and the mesh of ranks (`torch.distributed`, one process per device) with
the PRN-sharded acquisition, channel-sharded tracking and vector tracking,
the WLS epoch reduced over the ranks, and the multi-process launcher."""

from gps_sdr_tpu_torch.parallel.acquisition import sharded_acquisition_power
from gps_sdr_tpu_torch.parallel.epoch import (make_epoch_solver,
                                              sharded_wls_epoch,
                                              sharded_wls_normal_equations)
from gps_sdr_tpu_torch.parallel.mesh import (AXIS, Mesh, make_mesh,
                                             resolve_mesh)
from gps_sdr_tpu_torch.parallel.time_segments import (
    run_tracking_segmented, segmented_initial_state, stitch_segments)
from gps_sdr_tpu_torch.parallel.tracking import pad_channels, sharded_tracker
from gps_sdr_tpu_torch.parallel.vt import pad_vt_state, sharded_vt_scan

__all__ = ["AXIS", "Mesh", "make_epoch_solver", "make_mesh", "pad_channels",
           "pad_vt_state", "resolve_mesh", "run_tracking_segmented",
           "segmented_initial_state", "sharded_acquisition_power",
           "sharded_tracker", "sharded_vt_scan", "sharded_wls_epoch",
           "sharded_wls_normal_equations", "stitch_segments"]
