"""The benchmark of gaustar_tpu_torch: GauSTAR's refine step on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and per-layer metrics are files found
by name (BENCHMARK.json, configs/, mixes/, metrics/, limits/); the plain
reference that decides `correct` is in reference/.
"""
