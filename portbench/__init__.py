"""The benchmark of the PyTorch/CUDA port (``repro_torch``): Poisson draws
and full joins over a TPC-H deployment on one H100.
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; ``BENCHMARK.json`` is the manifest."""
