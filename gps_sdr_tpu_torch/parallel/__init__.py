"""Parallel tracking paths.  On one device so far: time-segmented
(overlap-save) tracking of the eph stage."""

from gps_sdr_tpu_torch.parallel.time_segments import (
    run_tracking_segmented, segmented_initial_state, stitch_segments)

__all__ = ["run_tracking_segmented", "segmented_initial_state",
           "stitch_segments"]
