"""The reference-scale runs on the card (counterparts of the JAX
repository's examples/refscale_*.py): one frame end to end, two frames
through run_sequence, detection at real capture statistics, the
160-camera flow warp. Each module is an entry point,
`python -m gaustar_tpu_torch.refscale.<name>`, writing its record to
build/refscale/<name>.json."""
