"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on an H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; ``README.md`` says how the
files are laid out and how a configuration, a cell or a metric is added.
"""
