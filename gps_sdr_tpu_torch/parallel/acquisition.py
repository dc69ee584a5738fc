"""PRN-sharded acquisition: the search grid is data parallel over code
replicas (reference hot loop acquisition.m:47-61).

The counterpart of `sharded_acquisition_power` in the JAX package's
`gps_sdr_tpu/parallel/acquisition.py`: each rank computes the power of
its slice of the PRN axis on the port's cuFFT grid
(`acquisition.acquisition_power_grid`), the per-block carrier-mix FFTs
replicated, and the slices are gathered in rank order.  Each PRN's power is
computed as in the unsharded grid.

Not ported, on purpose: `sharded_acquisition_power_real` and the sharding
of the Doppler axis.  They wrap the power-of-two real-pair grid, a TPU
workaround (the hosted TPU backend has no complex FFTs and only power-of-two
sizes) that the port does not carry.
"""

from __future__ import annotations

import torch

from gps_sdr_tpu_torch.acquisition import acquisition_power_grid
from gps_sdr_tpu_torch.parallel.mesh import Mesh


def sharded_acquisition_power(mesh: Mesh, prn_chunk: int = 8):
    """Returns power_fn(blocks, carriers, code_fft) → (P, F, S) float32,
    the grid of `acquisition_power_grid` with its PRN axis sharded over
    `mesh`: padded with (−P) mod size zero replicas, this rank's slice
    computed, the slices gathered in rank order and cut to P.  A drop-in
    for `run_acquisition(power_fn=…)`."""

    def fn(blocks: torch.Tensor, carriers: torch.Tensor,
           code_fft: torch.Tensor) -> torch.Tensor:
        p = code_fft.shape[0]
        pad = (-p) % mesh.size
        if pad:
            code_fft = torch.cat([code_fft,
                                  code_fft.new_zeros((pad, code_fft.shape[1]))])
        mine = code_fft[mesh.rows(p + pad)]
        return mesh.all_gather_rows(
            acquisition_power_grid(blocks, carriers, mine, prn_chunk), p)

    return fn
