"""Run one cell of the H100 benchmark of orion_kmer_tpu_torch once.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for (``BENCHMARK.json``).  The window calls the port's CLI
(``orion_kmer_tpu_torch.cli.main``) in this process, one whole command
after another, on inputs made from the seed; its large outputs go to named
pipes under ``TMPDIR`` that the benchmark drains and digests.  Then the
plain reference of ``h100bench/reference/`` judges every call's output.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (end-to-end with ``--trace 0``,
per-layer with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit;
the same checks end standard error.  Without a card, or with JAX or the
JAX package loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from h100bench.harness import runner  # noqa: E402

if __name__ == "__main__":
    t_process = runner.process_start()
    sys.exit(runner.main(sys.argv[1:], t_process))
