"""``count -k K -i READS -o <pipe> -m M [--histogram FILE]``: the traffic
names K (``k``), M (``min_count``) and whether to ask for the histogram
(``histogram``).  One call's work is the valid K-mer windows of the
reads.  Judged: the TSV's and the histogram's bytes of every call."""

from __future__ import annotations

from h100bench.harness.digest import PipeSink, consume_stream, tree_digest
from h100bench.reference import count as reference


class Job:
    def __init__(self, ctx):
        t = ctx.traffic
        self.ctx = ctx
        self.k = t["k"]
        self.min_count = t["min_count"]
        self.tsv = PipeSink(ctx.workdir / "counts.tsv", consume_stream, ctx.pool, ctx.buffers)
        self.hist = ctx.workdir / "histogram.txt" if t["histogram"] else None
        self.argv = ["count", "-k", str(self.k), "-i", str(ctx.inputs.reads_path), "-o", self.tsv.path,
                     "-m", str(self.min_count)]
        if self.hist is not None:
            self.argv += ["--histogram", str(self.hist)]
        self.work = ctx.inputs.valid_windows(self.k)
        self.warm_argv = self.argv  # a smaller input would not reach the table's flush and spill sizes

    def collect(self) -> dict:
        out = {"tsv": self.tsv.collect()}
        if self.hist is not None:
            out["histogram"] = tree_digest(self.hist.read_bytes())
            self.hist.unlink()
        return out

    def _reference(self, fn) -> dict:
        c, i = self.ctx, self.ctx.inputs
        exp = fn(i.reads_path, i.read_len, i.head_w, self.k, self.min_count, c.device, c.pool)
        if self.hist is None:
            del exp["histogram"]
        return exp

    def expected(self) -> dict:
        return self._reference(reference.expected)

    def control(self) -> dict:
        return self._reference(reference.control)

    def judge(self, outputs: list[dict], expected: dict) -> list[tuple[str, int, int]]:
        checks = [("tsv_calls_differing", sum(o["tsv"] != expected["tsv"] for o in outputs), 0)]
        if self.hist is not None:
            checks.append(("histogram_calls_differing",
                           sum(o["histogram"] != expected["histogram"] for o in outputs), 0))
        return checks

    def close(self) -> None:
        self.tsv.close()


def prepare(ctx) -> Job:
    return Job(ctx)
