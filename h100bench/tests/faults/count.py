"""The faults planted under ``count``: the count table's update
(``DeviceCountTable.update_packed``) and the command's ``count_file``."""

from orion_kmer_tpu_torch import engine


def unchanged(monkeypatch):
    """A step that returns its state unchanged: no batch reaches the table."""
    monkeypatch.setattr(engine.DeviceCountTable, "update_packed", lambda self, *a: None)


def half_batch(monkeypatch):
    """Half of every batch left out: only its first half of positions is
    counted."""
    update = engine.DeviceCountTable.update_packed
    monkeypatch.setattr(engine.DeviceCountTable, "update_packed",
                        lambda self, lanes, inv, size, n: update(self, lanes, inv, size, n // 2))


def altered(monkeypatch):
    """One answer altered where it is produced: a count."""
    count_file = engine.count_file

    def altered_count(*a, **kw):
        vals, counts = count_file(*a, **kw)
        counts = counts.copy()
        counts[len(counts) // 2] += 1
        return vals, counts

    monkeypatch.setattr("orion_kmer_tpu_torch.commands.count.count_file", altered_count)
