"""``query -d DB -r READS -o <pipe> -c C``: the traffic names the DB's K
(``k``) and C (``min_hits``).  The DB is the configuration's reference
genomes' k-mer sets, computed by the reference and written by the
benchmark in the KmerDbV2 layout during set-up.  One call's work is the
valid K-mer windows of the reads.  Judged: the ids each call writes."""

from __future__ import annotations

import numpy as np
import torch

from h100bench.harness.digest import PipeSink, consume_stream
from h100bench.reference import bincode
from h100bench.reference import query as reference


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        self.k = ctx.traffic["k"]
        self.min_hits = ctx.traffic["min_hits"]
        sets = reference.genome_sets(ctx.inputs.genomes, self.k, ctx.device)
        self.db_path = ctx.workdir / "references.db"
        bincode.write_db(self.db_path, self.k, sets)
        all_keys = torch.from_numpy(np.concatenate(list(sets.values())).view(np.int64)).to(ctx.device)
        self.union = torch.unique(all_keys, sorted=True).cpu().numpy().view(np.uint64)
        self.ids = PipeSink(ctx.workdir / "ids.txt", consume_stream, ctx.pool, ctx.buffers)
        self.argv = ["query", "-d", str(self.db_path), "-r", str(ctx.inputs.reads_path), "-o", self.ids.path,
                     "-c", str(self.min_hits)]
        self.work = ctx.inputs.valid_windows(self.k)
        self.warm_argv = self.argv  # the whole reads: the per-read buffers grow with them

    def collect(self) -> dict:
        return {"ids": self.ids.collect()}

    def _reference(self, fn) -> dict:
        c, i = self.ctx, self.ctx.inputs
        return fn(i.reads_path, i.read_len, i.head_w, self.k, self.union, self.min_hits, c.device, c.pool)

    def expected(self) -> dict:
        return self._reference(reference.expected)

    def control(self) -> dict:
        return self._reference(reference.control)

    def judge(self, outputs: list[dict], expected: dict) -> list[tuple[str, int, int]]:
        return [("ids_calls_differing", sum(o["ids"] != expected["ids"] for o in outputs), 0)]

    def close(self) -> None:
        self.ids.close()


def prepare(ctx) -> Job:
    return Job(ctx)
