"""The benchmark of dorylus_tpu_torch on the card: `python3 perfbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>` (see run.py)."""
