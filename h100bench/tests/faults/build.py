"""The faults planted under ``build``: the count table's update, which
each genome's set goes through, as under ``count``, and the command's
``count_file``."""

from pathlib import Path

from h100bench.harness.manifest import load_module
from orion_kmer_tpu_torch import engine

count = load_module(Path(__file__).with_name("count.py"), "faults")
unchanged = count.unchanged
half_batch = count.half_batch


def altered(monkeypatch):
    """One answer altered where it is produced: a database's k-mer."""
    count_file = engine.count_file

    def altered_set(*a, **kw):
        vals, counts = count_file(*a, **kw)
        return vals[:-1], counts[:-1]

    monkeypatch.setattr("orion_kmer_tpu_torch.commands.build.count_file", altered_set)
