"""Pipeline: depth backends, the fused labeling program, stages, config,
the scene-directory contract and the CLI runner (`pipeline/runner.py`)."""
