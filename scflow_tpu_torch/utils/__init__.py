"""Utilities: per-stage wall-clock timing and the profiler trace
(timer.py)."""
