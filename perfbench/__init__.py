"""Benchmark of clrs_tpu_torch, the PyTorch and CUDA port: whole solves on
one card, driven by ``BENCHMARK.json`` and the data files beside this
package. Entry point: ``python3 perfbench/run.py --workload <cell> ...``."""
