"""Hand-written Hopper kernels (sources in `csrc/`) and their wrappers."""
