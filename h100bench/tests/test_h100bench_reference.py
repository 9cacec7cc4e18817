"""The generators repeat by seed, and the plain reference agrees with a
brute-force Python count at a tiny size, for count, build and query."""

from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from h100bench.harness.digest import tree_digest
from h100bench.harness.inputs import Workdir
from h100bench.harness.manifest import Manifest
from h100bench.reference import build as ref_build
from h100bench.reference import count as ref_count
from h100bench.reference import kmers
from h100bench.reference import query as ref_query
from h100bench.tests.helpers import ROOT, configs, tiny

COMP = str.maketrans("ACGT", "TGCA")
CPU = torch.device("cpu")


def make(config: str, seed: int, base: Path):
    """The inputs of a tiny ``config``, in a Workdir under ``base`` that
    lives as long as the test process (its memory files too)."""
    man = Manifest(ROOT)
    cfg = {**man.config(config), **tiny(man, config)}
    return man.generator(cfg["generator"]).make(cfg, seed, Workdir(base), CPU)


def canonical_windows(seq: str, k: int):
    for i in range(len(seq) - k + 1):
        w = seq[i : i + k]
        if set(w) <= set("ACGT"):
            yield min(w, w.translate(COMP)[::-1])


def fastq_reads(path: Path) -> list[tuple[str, str]]:
    lines = path.read_text().split("\n")
    return [(lines[i][1:], lines[i + 1]) for i in range(0, len(lines) - 1, 4)]


@pytest.fixture(scope="module")
def pool():
    with ThreadPoolExecutor(2) as p:
        yield p


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    return make("ecoli-illumina-1gbp", 2**31 + 11, d)


def input_files(inputs) -> dict[str, bytes]:
    """The bytes of every file an ``Inputs`` names, alone or in a list,
    under its key and place (a file in memory has a new path each time)."""
    out = {}
    for key, value in sorted(vars(inputs).items()):
        for i, p in enumerate(value if isinstance(value, list) else [value]):
            if isinstance(p, Path):
                out[f"{key}/{i}"] = p.read_bytes()
    return out


@pytest.mark.parametrize("config", configs())
def test_generators_repeat_by_seed(tmp_path, config):
    def files(seed):
        return input_files(make(config, seed, tmp_path))

    a, b, c = files(5_000_000_000), files(5_000_000_000), files(5_000_000_001)
    assert a and a == b
    assert a.keys() == c.keys() and all(a[p] != c[p] for p in a)


def test_reads_layout_and_valid_windows(reads):
    recs = fastq_reads(reads.reads_path)
    assert len(recs) == reads.n_reads and all(len(s) == reads.read_len for _, s in recs)
    assert reads.bases == reads.n_reads * reads.read_len
    assert reads.reads_with_n == sum("N" in s for _, s in recs) > 0
    for k in (21, 31):
        assert reads.valid_windows(k) == sum(1 for _, s in recs for _ in canonical_windows(s, k))


@pytest.mark.parametrize("k", [21, 31])
def test_count_reference_matches_brute_force(reads, pool, k):
    counts = Counter(w for _, s in fastq_reads(reads.reads_path) for w in canonical_windows(s, k))
    tsv = "".join(f"{w}\t{c}\n" for w, c in sorted(counts.items()) if c >= 2).encode()
    hist = "".join(f"{m}\t{f}\n" for m, f in sorted(Counter(counts.values()).items())).encode()
    got = ref_count.expected(reads.reads_path, reads.read_len, reads.head_w, k, 2, CPU, pool)
    assert got["tsv"] == tree_digest(tsv) and got["histogram"] == tree_digest(hist)
    assert got["distinct"] == len(counts)
    ctl = ref_count.control(reads.reads_path, reads.read_len, reads.head_w, k, 2, CPU, pool)
    assert ctl["distinct"] == got["distinct"]  # 40 bits are exact at this size


def test_build_reference_matches_brute_force(tmp_path, pool):
    genomes = make("bacteria-50x5mbp", 77, tmp_path)
    got = ref_build.expected(genomes.genome_paths, 31, CPU, pool)
    assert got["k"] == 31 and len(got["refs"]) == len(genomes.genome_paths)
    for path in genomes.genome_paths:
        seq = "".join(path.read_text().split("\n")[1:])
        assert len(seq) == tiny(Manifest(ROOT), "bacteria-50x5mbp")["genome_bp"]
        words = sorted(set(canonical_windows(seq, 31)))
        vals = np.array([int(w.translate(str.maketrans("ACGT", "0123")), 4) for w in words], np.uint64)
        assert got["refs"][path.name] == (len(words), tree_digest(vals.astype("<u8")))


def test_query_reference_matches_brute_force(reads, pool):
    k = 31
    sets = ref_query.genome_sets(reads.genomes, k, CPU)
    union = np.unique(np.concatenate(list(sets.values())))
    words = set()
    for codes in reads.genomes.values():
        words |= set(canonical_windows("".join("ACGT"[c] for c in codes.tolist()), k))
    assert union.shape[0] == len(words)
    recs = fastq_reads(reads.reads_path)
    hits = [sum(w in words for w in canonical_windows(s, k)) for _, s in recs]
    rows, got_hits = ref_query.hits(reads.reads_path, reads.read_len, reads.head_w, k, union, CPU)
    assert got_hits.tolist() == hits
    ids = "".join(f"{i}\n" for (i, s), h in zip(recs, hits) if h >= 10 and len(s) >= k).encode()
    got = ref_query.expected(reads.reads_path, reads.read_len, reads.head_w, k, union, 10, CPU, pool)
    assert got["ids"] == tree_digest(ids)


def test_window_keys_rejects_k_over_31():
    with pytest.raises(ValueError):
        kmers.window_keys(torch.zeros((1, 40), dtype=torch.uint8), 32)
