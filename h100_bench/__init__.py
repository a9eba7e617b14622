"""The H100 benchmark of the PyTorch and CUDA port (``esdg_cns_tpu_torch``).

``python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card.  The
harness is driven by data: a cell is ``workloads/<cell>.json``, its
configuration ``configs/<config>.json`` with ``configs/<config>.py`` (the
program's set-up, the start state and the plain reference's problem), and
each per-layer metric ``metrics/<metric>.py`` (``read(trace) -> value or
None``).  ``reference/`` is the frozen plain float64 reference,
``roofline.py`` the frozen operation and byte counts with the card's
published peaks.
"""
