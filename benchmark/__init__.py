"""The benchmark of ``hpgq_torch``: one cell of FASTQ QC run once, by
``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``README.md``)."""
