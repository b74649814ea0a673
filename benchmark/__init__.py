"""The benchmark of tyleri_tpu_torch on one CUDA card: frame time, its tail
and frame latency of the port's real frame loop (``RenderWindow``), with a
plain PyTorch reference that decides whether the presented frames are
correct.  ``python3 -m benchmark.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` runs one cell once; ``BENCHMARK.json`` names the cells.
"""
