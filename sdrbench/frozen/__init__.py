"""Frozen copies of the port's capture synthesizer and the geodesy and
navigation-message encoder it uses (`gps_sdr_tpu_torch.io.synthetic`,
`geo/*`, `io/lnav`, `ops/cacode`), so the benchmark's inputs stay fixed
whatever later changes the program."""
