"""``build -k K -g <genomes> -o <pipe>``: the traffic names K (``k``).
One call's work is the bases of the genome assemblies.  Judged: what each
call's database holds, read from its bincode stream: k, and under each
genome's file name its number of k-mers and the digest of their bytes
(ascending, as the port writes them)."""

from __future__ import annotations

from h100bench.harness.digest import PipeSink, consume_bincode_db
from h100bench.reference import build as reference


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        self.k = ctx.traffic["k"]
        self.db = PipeSink(ctx.workdir / "kmers.db", consume_bincode_db, ctx.pool, ctx.buffers)
        self.argv = ["build", "-k", str(self.k), "-g", *map(str, ctx.inputs.genome_paths), "-o", self.db.path]
        self.work = ctx.inputs.bases
        # every genome is one batch of one shape: two of them warm every kernel and size
        self.warm_argv = ["build", "-k", str(self.k), "-g", *map(str, ctx.inputs.genome_paths[:2]), "-o", self.db.path]

    def collect(self) -> dict:
        return {"db": self.db.collect()}

    def expected(self) -> dict:
        c = self.ctx
        return {"db": reference.expected(c.inputs.genome_paths, self.k, c.device, c.pool)}

    def control(self) -> dict:
        c = self.ctx
        return {"db": reference.control(c.inputs.genome_paths, self.k, c.device, c.pool)}

    def judge(self, outputs: list[dict], expected: dict) -> list[tuple[str, int, int]]:
        exp = expected["db"]
        wrong = 0
        for o in outputs:
            got = o["db"]
            if not isinstance(got, dict) or got["k"] != exp["k"]:
                wrong += len(exp["refs"])
                continue
            names = set(got["refs"]) | set(exp["refs"])
            wrong += sum(got["refs"].get(n) != exp["refs"].get(n) for n in names)
        return [("db_references_differing", wrong, 0)]

    def close(self) -> None:
        self.db.close()


def prepare(ctx) -> Job:
    return Job(ctx)
