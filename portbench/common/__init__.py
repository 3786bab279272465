"""Pieces every cell of the benchmark shares: the environment of a run,
seeded weights, the traced window, the frozen roofline arithmetic, and the
comparisons that decide `correct`."""
