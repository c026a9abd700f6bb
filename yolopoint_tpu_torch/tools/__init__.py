"""Command-line tools of the port, run with `python -m`: the synthetic-data
tools (`synthetic_hpatches`, `synthetic_dataset`, `synthetic_sequence`), the
SuperPoint-style bootstrap chain (`bootstrap`) and its summary
(`summarize_run`), the counterparts of the JAX package's `tools/` scripts of
those names."""
