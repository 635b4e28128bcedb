"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line. Configurations, traffic mixes, cells and metric readers are
files under this folder, found by the names ``BENCHMARK.json`` gives.
"""
