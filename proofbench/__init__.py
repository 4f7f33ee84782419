"""The port's benchmark: `python3 -m proofbench.run` (see run.py)."""
