"""The port's sketch slice: the batch sketch (ops/sketch.py) against the
JAX package's ``sketch_packed`` and the numpy oracle ``sketch_np``, and
the ``sketch`` / ``sketch-compare`` CLI against orion_kmer_tpu.cli.main,
byte for byte."""

import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_kmer_tpu import codec
from orion_kmer_tpu.cli import main as jax_main
from orion_kmer_tpu.engine import pack_for_transfer
from orion_kmer_tpu.ops import sketch as jax_sketch
from orion_kmer_tpu.ops.kmers import join_u64
from orion_kmer_tpu_torch.keys import u64_from_keys
from orion_kmer_tpu_torch.ops import sketch as port_sketch

from .test_torch_count import _assert_dirs_equal, _run_both, port_cpu
from .test_torch_ingest import jax_native_loaded  # noqa: F401  (a fixture)
from .test_torch_joins import _error_of_both, _tiny_batch
from .util import write_file

pytestmark = pytest.mark.usefixtures("jax_native_loaded")

_EXTS = ["", ".gz", ".xz", ".zst"]


def _codes(seed, n):
    """Random 2-bit codes with N runs and a T*40 run (255 = invalid)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    for p in rng.integers(0, n - 30, size=n // 2000):
        codes[p : p + int(rng.integers(1, 8))] = 255
    codes[100:140] = 3  # T*40: canonical A^k at every k, A^32 at k = 32
    return codes


def _jax_sketch(lanes, inv, k, scaled):
    """The JAX batch sketch, with its dense retry on overflow."""
    args = (jnp.asarray(lanes), jnp.asarray(inv), k, scaled)
    uhi, ulo, cnt, nu, ovf = jax_sketch.sketch_packed(*args)
    if int(ovf):
        uhi, ulo, cnt, nu, _ = jax_sketch.sketch_packed(*args, dense=True)
    nu = int(nu)
    return join_u64(np.asarray(uhi)[:nu], np.asarray(ulo)[:nu]), np.asarray(cnt)[:nu].astype(np.int64)


def _port_sketch(lanes, inv, k, n_positions, scaled):
    h, c = port_sketch.sketch_packed(
        torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(inv.view(np.int32)), k, n_positions, scaled
    )
    return u64_from_keys(h), c.numpy()


def _oracle(codes, k, scaled):
    """Sorted kept hashes and their abundances from the codec windows."""
    vals, counts = np.unique(codec.extract_kmers_np(codes, k), return_counts=True)
    h = jax_sketch.splitmix64_np(vals)
    keep = h < np.uint64((1 << 64) // scaled) if scaled > 1 else np.ones(h.shape, bool)
    order = np.argsort(h[keep])
    return h[keep][order], counts[keep][order]


@pytest.mark.parametrize("scaled", [1, 2, 1000])
@pytest.mark.parametrize("k", [1, 15, 21, 31, 32])
def test_sketch_packed_matches_jax_and_oracle(k, scaled):
    n = 1 << 16
    codes = _codes(k, n - 11)
    lanes, inv = pack_for_transfer(codes, n)
    got_h, got_c = _port_sketch(lanes, inv, k, n - 11, scaled)
    exp_h, exp_c = _jax_sketch(lanes, inv, k, scaled)
    np.testing.assert_array_equal(got_h, exp_h)
    np.testing.assert_array_equal(got_c, exp_c)
    ora_h, ora_c = _oracle(codes, k, scaled)
    np.testing.assert_array_equal(got_h, ora_h)
    np.testing.assert_array_equal(got_c, ora_c)
    if scaled > 1:  # sketch_np's threshold 2^64 fits no uint64 at scaled = 1
        kmers = codec.extract_kmers_np(codes, k)
        np.testing.assert_array_equal(got_h, jax_sketch.sketch_np(kmers, scaled))
        np.testing.assert_array_equal(got_h, port_sketch.sketch_np(kmers, scaled))
    if k >= 15:
        assert got_h.shape[0] > 30


def test_sketch_t40_k32_edge():
    """T*40 at k = 32: nine windows of canonical A^32 (key 0), kept at
    scaled = 1 as one hash of abundance 9."""
    codes = np.full(40, 3, np.uint8)
    lanes, inv = pack_for_transfer(codes, 4096)
    got_h, got_c = _port_sketch(lanes, inv, 32, 40, 1)
    np.testing.assert_array_equal(got_h, jax_sketch.splitmix64_np(np.zeros(1, np.uint64)))
    np.testing.assert_array_equal(got_c, [9])
    exp_h, exp_c = _jax_sketch(lanes, inv, 32, 1)
    np.testing.assert_array_equal(got_h, exp_h)
    np.testing.assert_array_equal(got_c, exp_c)


def test_sketch_duplicate_heavy_input_is_exact():
    """tests/test_sketch.py:127: a period-4 repeat whose one kept hash has a
    multiplicity far above the JAX sparse capacity; the JAX package needs
    its dense retry, the port is exact in one pass."""
    n, scaled, k = 1 << 17, 64, 4
    codes = np.tile(np.array([0, 1, 0, 3], dtype=np.uint8), n // 4)
    lanes, inv = pack_for_transfer(codes, n)
    got_h, got_c = _port_sketch(lanes, inv, k, n, scaled)
    exp_h, exp_c = _jax_sketch(lanes, inv, k, scaled)
    np.testing.assert_array_equal(got_h, exp_h)
    np.testing.assert_array_equal(got_c, exp_c)
    ora_h, ora_c = _oracle(codes, k, scaled)
    np.testing.assert_array_equal(got_h, ora_h)
    np.testing.assert_array_equal(got_c, ora_c)
    assert got_c.max() > 8 * n // scaled


def _genomes(seed):
    rng = np.random.default_rng(seed)
    g1 = "".join(rng.choice(list("ACGT"), size=3000))
    g2 = g1[:2400] + "".join(rng.choice(list("ACGT"), size=600)) + "N" * 5 + "T" * 40
    return g1, g2


@pytest.mark.parametrize("num", [0, 20])
@pytest.mark.parametrize("ext", _EXTS)
def test_sketch_cli_matches_jax(tmp_path, monkeypatch, ext, num):
    """sketch and sketch-compare byte-equal on plain, .gz, .xz and .zst
    inputs, with and without --num, in 640-position batches."""
    _tiny_batch(monkeypatch)
    g1, g2 = _genomes(len(ext) + num)
    f1 = write_file(tmp_path / f"g1.fa{ext}", f">g1\n{g1}\n")
    f2 = write_file(tmp_path / f"g2.fq{ext}", f"@g2\n{g2}\n+\n{'I' * len(g2)}\n")
    extra = ["--num", num] if num else []
    for k, scaled in ((21, 10), (32, 1)):
        (tmp_path / f"k{k}").mkdir()
        (tmp_path / f"c{k}").mkdir()
        a, b = _run_both(tmp_path / f"k{k}", lambda d: ["sketch", "-k", k, "--scaled", scaled, "-i", f1, f2, "-o", d / "s.sig", *extra])
        _assert_dirs_equal(a, b)
        doc = json.loads((b / "s.sig").read_text())
        assert len(doc["sketches"]) == 2 and all(s["hashes"] for s in doc["sketches"])
        if num:
            assert all(len(s["hashes"]) == num for s in doc["sketches"])
        c, d_ = _run_both(tmp_path / f"c{k}", lambda d: ["sketch-compare", "-s", b / "s.sig", "-o", d / "cmp.json"])
        _assert_dirs_equal(c, d_)


def test_sketch_cli_multi_batch_default_scaled(tmp_path, monkeypatch):
    """Several genomes across 640-position batches at the default scaled
    (1000) and k = 31; the sketches agree with the oracle."""
    _tiny_batch(monkeypatch)
    rng = np.random.default_rng(9)
    seqs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(20000, 40000)))) for _ in range(3)]
    f = write_file(tmp_path / "g.fa", "".join(f">g{i}\n{s}\n" for i, s in enumerate(seqs)))
    a, b = _run_both(tmp_path, lambda d: ["sketch", "-k", 31, "-i", f, "-o", d / "s.sig.gz"])
    _assert_dirs_equal(a, b)
    doc = json.loads(gzip.decompress((b / "s.sig.gz").read_bytes()))
    kmers = np.concatenate([codec.extract_kmers_np(codec.seq_to_codes(s.encode()), 31) for s in seqs])
    exp = jax_sketch.sketch_np(kmers, 1000)
    assert [int(h) for h in doc["sketches"][0]["hashes"]] == exp.tolist()


def test_sketch_error_paths_match_jax(tmp_path, capsys):
    f = write_file(tmp_path / "g.fa", ">g\nACGTACGTACGTACGTACGTACGT\n")
    s11, s13 = tmp_path / "a.sig", tmp_path / "b.sig"
    assert port_cpu(["sketch", "-k", 11, "--scaled", 1, "-i", f, "-o", s11]) == 0
    assert port_cpu(["sketch", "-k", 13, "--scaled", 1, "-i", f, "-o", s13]) == 0
    capsys.readouterr()
    assert "Sketch parameter mismatch" in _error_of_both(capsys, ["sketch-compare", "-s", s11, s13, "-o", tmp_path / "o.json"])
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"format": "something-else"}))
    assert "Not an orion-kmer-tpu sketch file" in _error_of_both(capsys, ["sketch-compare", "-s", other, "-o", tmp_path / "o.json"])
    garbage = tmp_path / "garbage.sig"
    garbage.write_text("not json")
    assert "Failed to load sketch file" in _error_of_both(capsys, ["sketch-compare", "-s", garbage, "-o", tmp_path / "o.json"])
    assert "missing.fa" in _error_of_both(capsys, ["sketch", "-k", 5, "-i", tmp_path / "missing.fa", "-o", tmp_path / "o.sig"])
    # --scaled 0: both packages raise the same ValueError out of main (a
    # traceback and exit 1 from ``python -m``)
    errors = []
    for main in (jax_main, port_cpu):
        with pytest.raises(ValueError) as e:
            main(["sketch", "-k", 5, "--scaled", 0, "-i", f, "-o", tmp_path / "z.sig"])
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "scaled must be >= 1, got 0"


def _random_sig(rng, path, k, scaled, names, pool):
    """A .sig document over ``names``; each sketch draws hashes from
    ``pool`` (so sketches overlap), a name ending in "empty" stays empty,
    and one sketch repeats some of its hashes (a hand-edited file)."""
    sketches = []
    for i, name in enumerate(names):
        n = 0 if name.endswith("empty") else int(rng.integers(1, pool.shape[0]))
        h = rng.choice(pool, size=n, replace=False)
        if i == 1 and n:
            h = np.concatenate([h, h[: n // 3]])
        sketches.append({"name": name, "hashes": [str(x) for x in h.tolist()], "abundances": [1] * h.shape[0]})
    doc = {"format": "orion-kmer-tpu-sketch", "version": 1, "k": k, "scaled": scaled, "num": 0, "sketches": sketches}
    path.write_text(json.dumps(doc))
    return [np.unique(np.array([int(x) for x in s["hashes"]], dtype=np.uint64)) for s in sketches]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sketch_compare_fuzz_matches_jax(tmp_path, seed):
    """Randomized sketch-compare over two .sig files: overlapping
    sketches, an empty one, a name in both files, duplicate hashes and
    hashes at both ends of the u64 range; byte-equal to the JAX CLI and
    each pair equal to sketch_compare of the unique hashes."""
    rng = np.random.default_rng(seed)
    pool = np.unique(np.concatenate([rng.integers(0, 1 << 64, size=400, dtype=np.uint64),
                                     np.array([0, (1 << 64) - 1], np.uint64)]))
    s1 = _random_sig(rng, tmp_path / "a.sig", 21, 100, ["x.fa", "y.fa", "z_empty"], pool)
    s2 = _random_sig(rng, tmp_path / "b.sig", 21, 100, ["x.fa", "w.fa"], pool)
    a, b = _run_both(tmp_path, lambda d: ["sketch-compare", "-s", tmp_path / "a.sig", tmp_path / "b.sig", "-o", d / "cmp.json"])
    _assert_dirs_equal(a, b)
    got = json.loads((b / "cmp.json").read_text())
    sets = s1 + s2
    assert got["num_sketches"] == len(sets) and len(got["pairs"]) == len(sets) * (len(sets) - 1) // 2
    pairs = iter(got["pairs"])
    for i in range(len(sets)):
        for j in range(i + 1, len(sets)):
            p = next(pairs)
            exp = port_sketch.sketch_compare(sets[i], sets[j])
            assert {key: p[key] for key in exp} == exp == jax_sketch.sketch_compare(sets[i], sets[j])


def test_pairwise_intersections_matches_jax():
    rng = np.random.default_rng(7)
    sketches = [np.unique(rng.integers(0, 500, size=rng.integers(0, 200), dtype=np.uint64)) for _ in range(12)]
    sketches[3] = np.empty(0, dtype=np.uint64)
    sketches[5] = sketches[2].copy()
    np.testing.assert_array_equal(
        port_sketch.pairwise_intersections(sketches), jax_sketch.pairwise_intersections(sketches)
    )
