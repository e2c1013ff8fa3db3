"""The port's copies of the JAX package's user tools (tools/*.py), reached
as subcommands of scflow_tpu_torch.cli: overfit_check (cli overfit),
bf16_parity (cli bf16-parity), serve_bench (cli serve-bench) and
warmup_cache (cli warmup)."""
