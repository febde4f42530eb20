"""Adapters from a configuration's problem parameters to the port's own
problem builders (``clrs_tpu_torch/examples.py``), one file a family."""
