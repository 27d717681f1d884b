"""The port's benchmark: python benchmark/run.py --workload <cell> ... (see run.py)."""
