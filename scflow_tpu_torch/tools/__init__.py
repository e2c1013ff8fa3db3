"""The port's copies of the JAX package's user tools (tools/*.py), reached
as subcommands of scflow_tpu_torch.cli: overfit_check (cli overfit),
bf16_parity (cli bf16-parity), serve_bench (cli serve-bench), warmup_cache
(cli warmup), collect_3d_keypoints (cli keypoints), browse_dataset (cli
browse), visualize (cli visualize) and mmflow_ckpt_converter (cli
mmflow-convert)."""
