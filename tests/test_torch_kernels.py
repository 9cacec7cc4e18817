"""The port's kernel wrappers: dispatch (plain version on the CPU, kernel
or an error elsewhere, never a quiet fallback), and -- on a card -- each
CUDA kernel against its plain version at edge shapes.

This file imports no jax, so the card tests run on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from orion_kmer_tpu_torch import _kernels, codec
from orion_kmer_tpu_torch.host import pack_for_transfer
from orion_kmer_tpu_torch.keys import SENTINEL_KEY, keys_from_u64
from orion_kmer_tpu_torch.ops import compact, extract, merge, radix, setops, sort


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cpu_path_never_loads_the_kernels(monkeypatch):
    def no_kernels():
        raise AssertionError("the CPU path asked for the CUDA kernels")

    monkeypatch.setattr(_kernels, "lib", no_kernels)
    x = torch.arange(10, dtype=torch.int64)
    merge.merge(x, x)
    merge.merge_combine(x, x, x, x)
    compact.compact([x], x > 3)
    sort.sort_pairs(x)
    radix.sort_keys(x, 8)
    lanes, inv = _wire(np.random.default_rng(0), 100, 128)
    extract.extract_keys(lanes, inv, 5, 100)


def test_non_cpu_non_cuda_tensors_raise():
    device = "meta"
    x = torch.empty(8, dtype=torch.int64, device=device)
    with pytest.raises(ValueError):
        merge.merge(x, x)
    with pytest.raises(ValueError):
        merge.merge_combine(x, x, x, x)
    with pytest.raises(ValueError):
        compact.compact([x], torch.empty(8, dtype=torch.bool, device=device))
    with pytest.raises(ValueError):
        sort.sort_pairs(x)
    with pytest.raises(ValueError):
        radix.sort_keys(x, 62)
    with pytest.raises(ValueError):
        extract.extract_keys(
            torch.empty(8, dtype=torch.int32, device=device),
            torch.empty(4, dtype=torch.int32, device=device),
            5,
            64,
        )


def test_cpu_path_of_every_k3_mode_never_loads_the_kernels(monkeypatch):
    def no_kernels():
        raise AssertionError("the CPU path asked for the CUDA kernels")

    monkeypatch.setattr(_kernels, "lib", no_kernels)
    x = torch.arange(10, dtype=torch.int64)
    compact.compact([x, x], x > 3)
    compact.compact_positions(x, x > 3, torch.tensor(7))
    compact.partition(x, 3)


def test_every_k3_mode_raises_on_non_cpu_non_cuda_tensors():
    x = torch.empty(8, dtype=torch.int64, device="meta")
    keep = torch.empty(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        compact.compact_positions(x, keep)
    with pytest.raises(ValueError):
        compact.partition(x, 4)


def _wire(rng, n, size):
    seq = rng.choice(list(b"ACGTN"), size=n, p=[0.24] * 4 + [0.04]).astype(np.uint8)
    lanes, inv = pack_for_transfer(codec.seq_to_codes(seq.tobytes()), size)
    return torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(inv.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,size",
    # K1 walks 4224-position tiles: one partial tile, exact tiles, a ragged last tile
    [(1, 32), (5000, 8192), (4096, 4096), (8448, 8448), (12700, 12704), ((1 << 20) - 37, 1 << 20)],
)
def test_extract_kernel_matches_plain(cuda, n, size):
    rng = np.random.default_rng(n)
    lanes, inv = _wire(rng, n, size)
    for k in range(1, 33):
        pk, pn = extract.extract_keys_plain(lanes, inv, k, n)
        gk, gn = extract.extract_keys(lanes.to(cuda), inv.to(cuda), k, n)
        assert torch.equal(pk, gk.cpu()) and int(pn) == int(gn), k


@pytest.mark.cuda
@pytest.mark.parametrize(
    "na,nb", [(0, 5), (5, 0), (1, 1), (3000, 17), (2048, 2048), (100000, 333333)]
)
def test_merge_kernel_matches_plain(cuda, na, nb):
    rng = np.random.default_rng(na + nb)
    a = torch.sort(torch.from_numpy(rng.integers(-50, 50, na))).values
    b = torch.sort(torch.from_numpy(rng.integers(-50, 50, nb))).values
    pa, pb = torch.arange(na), torch.arange(nb) + na
    ek, ep = merge.merge_plain(a, b, pa, pb)
    gk, gp = merge.merge(a.to(cuda), b.to(cuda), pa.to(cuda), pb.to(cuda))
    assert torch.equal(ek, gk.cpu()) and torch.equal(ep, gp.cpu())
    gk2, none = merge.merge(a.to(cuda), b.to(cuda))
    assert none is None and torch.equal(ek, gk2.cpu())


def _k2_tiles() -> tuple:
    """Outputs a block of csrc/merge.cu merges, keys only and with a
    payload: kThreads * kItemsKeys and kThreads * kItemsPayload."""
    src = (Path(merge.__file__).resolve().parent.parent / "csrc" / "merge.cu").read_text()
    threads, keys, payload = (
        int(re.search(rf"constexpr int {c} = (\d+);", src).group(1)) for c in ("kThreads", "kItemsKeys", "kItemsPayload")
    )
    return threads * keys, threads * payload


# empty, one key, a tile less and more one on either side, many tiles
K2_LENGTHS = [(0, 0), (0, 1), (1, 0), (1, 1)] + [
    length for t in _k2_tiles() for length in ((t - 1, 0), (0, t + 1), (t - 1, t + 1), (t + 1, t - 1))
] + [((1 << 20) + 5, 333_333)]
K2_KINDS = ["random", "ties across tile edges", "a below b", "b below a", "sentinel tails"]
K2_REPEATS = 20


def _k2_runs(kind, na, nb, unique, rng):
    """Two ascending int64 runs of na and nb keys (each sorted unique when
    ``unique``, as the fold takes them): random keys from a narrow range,
    runs of equal keys longer than a tile (for the fold: the same keys on
    both sides, a pair at every position), one run wholly below the other,
    or long SENTINEL_KEY tails."""

    def side(m, lo):
        if kind == "ties across tile edges":
            v = torch.arange(m) if unique else torch.full((m,), 7)
        elif kind == "random" and unique:
            v = torch.from_numpy(np.sort(rng.choice(3 * (na + nb) + 3, m, replace=False)))
        elif kind == "random":
            v = torch.sort(torch.from_numpy(rng.integers(0, max(m // 3, 2), m))).values
        else:
            v = lo + (torch.arange(m) * 2 if unique else torch.arange(m) // 3)
            if kind == "sentinel tails" and m:
                v[m - (1 if unique else 2 * m // 5 + 1) :] = SENTINEL_KEY
        return v.to(torch.int64)

    lo_a = 10 * (nb + 1) if kind == "b below a" else 0
    lo_b = 10 * (na + 1) if kind == "a below b" else 0
    return side(na, lo_a), side(nb, lo_b)


def _k2_byte_identical(run, want):
    """run() equals want and K2_REPEATS - 1 more runs equal the first."""
    first = run()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(first, want))
    for _ in range(K2_REPEATS - 1):
        assert all(torch.equal(g, f) for g, f in zip(run(), first))


@pytest.mark.cuda
@pytest.mark.parametrize("na,nb", K2_LENGTHS)
@pytest.mark.parametrize("kind", K2_KINDS)
@pytest.mark.parametrize("mode", ["keys", "payload"])
def test_merge_kernel_modes_match_plain(cuda, na, nb, kind, mode):
    rng = np.random.default_rng(na * 3 + nb)
    a, b = _k2_runs(kind, na, nb, False, rng)
    pa, pb = (torch.arange(na), torch.arange(nb) + na) if mode == "payload" else (None, None)
    keys, payload = merge.merge_plain(a, b, pa, pb)
    on = [None if t is None else t.to(cuda) for t in (a, b, pa, pb)]
    before = merge.launches
    if mode == "payload":
        _k2_byte_identical(lambda: merge.merge(*on), (keys, payload))
    else:
        _k2_byte_identical(lambda: merge.merge(*on[:2])[:1], (keys,))
    assert merge.launches == before + (K2_REPEATS if na + nb else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("na,nb", K2_LENGTHS)
@pytest.mark.parametrize("kind", K2_KINDS)
def test_merge_kernel_fold_matches_plain(cuda, na, nb, kind):
    rng = np.random.default_rng(na * 5 + nb)
    a, b = _k2_runs(kind, na, nb, True, rng)
    ca = torch.from_numpy(rng.integers(1, 1 << 40, na))
    cb = torch.from_numpy(rng.integers(1, 1 << 40, nb))
    keys, cnt = merge.merge_plain(a, b, ca, cb)
    want = (keys, *merge.combine_merged_plain(keys, cnt))
    on = [t.to(cuda) for t in (a, b, ca, cb)]
    _k2_byte_identical(lambda: merge.merge_combine(*on), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 100, 2048, 2049, (1 << 20) + 5])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 0.97, 1.0])
def test_compact_kernel_matches_plain(cuda, n, density):
    rng = np.random.default_rng(n)
    keep = torch.from_numpy(rng.random(n) < density)
    x0 = torch.from_numpy(rng.integers(-(2**62), 2**62, n))
    x1 = torch.arange(n)
    (e0, e1), en = compact.compact_plain([x0, x1], keep)
    (g0, g1), gn = compact.compact([x0.to(cuda), x1.to(cuda)], keep.to(cuda))
    m = int(gn)
    assert m == int(en)
    assert torch.equal(e0, g0[:m].cpu()) and torch.equal(e1, g1[:m].cpu())


# K3 ranks 2048-element tiles: empty, one element, a tile less and more one,
# several tiles with a ragged end
K3_SIZES = [0, 1, 2047, 2049, (1 << 20) + 5]


@pytest.mark.cuda
@pytest.mark.parametrize("n", K3_SIZES)
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("offset", [0, 1])  # 1: a view that is not 16-byte aligned
def test_compact_one_plane_kernel_matches_plain(cuda, n, density, offset):
    rng = np.random.default_rng(n + offset)
    x = torch.from_numpy(rng.integers(-(2**62), 2**62, n + offset)).to(cuda)[offset:]
    keep = torch.from_numpy(rng.random(n + offset) < density).to(cuda)[offset:]
    (e,), en = compact.compact_plain([x], keep)
    (g,), gn = compact.compact([x], keep)
    m = int(gn)
    assert m == int(en) and torch.equal(e, g[:m])


@pytest.mark.cuda
@pytest.mark.parametrize("n", K3_SIZES)
@pytest.mark.parametrize("density", [0.0, 0.03, 0.97, 1.0])
@pytest.mark.parametrize("limit", [None, 0, 1000, 1 << 30])
def test_compact_positions_kernel_matches_plain(cuda, n, density, limit):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(-(2**62), 2**62, n)).to(cuda)
    keep = torch.from_numpy(rng.random(n) < density).to(cuda)
    lim = None if limit is None else torch.tensor(limit, device=cuda)
    (ek, ei), en = compact.compact_positions_plain(keys, keep, lim)
    before = compact.launches
    (gk, gi), gn = compact.compact_positions(keys, keep, lim)
    assert compact.launches == before + (n > 0)
    m = int(gn)
    assert m == int(en) and torch.equal(ek, gk[:m]) and torch.equal(ei, gi[:m])


@pytest.mark.cuda
@pytest.mark.parametrize("n", K3_SIZES)
@pytest.mark.parametrize("n_dest", [1, 2, 3, 4, 5, 8, 13])
def test_partition_kernel_matches_plain(cuda, n, n_dest):
    rng = np.random.default_rng(n * 31 + n_dest)
    keys = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, n + 1, dtype=np.int64)).to(cuda)
    keys[torch.from_numpy(rng.random(n + 1) < 0.1).to(cuda)] = SENTINEL_KEY
    keys = keys[1:]  # a view that is not 16-byte aligned
    ebufs, ecounts = compact.partition_plain(keys, n_dest)
    before = compact.launches
    gbufs, gcounts = compact.partition(keys, n_dest)
    assert compact.launches == before + (n > 0)
    assert torch.equal(ecounts, gcounts)
    for e, g, m in zip(ebufs, gbufs, gcounts.tolist()):
        assert torch.equal(e, g[:m])
    again = compact.partition(keys, n_dest)[0]
    assert all(torch.equal(a[:m], g[:m]) for a, g, m in zip(again, gbufs, gcounts.tolist()))


@pytest.mark.cuda
# K4 runs clusters of 1 (n <= 2048), 2, 4 and 8 CTAs
@pytest.mark.parametrize("n", [1, 2, 3, 1000, 2047, 2048, 2049, 4097, 8193, 12289, 1 << 14])
def test_sort_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64))
    keys[: n // 4] = keys[n // 4 : 2 * (n // 4)]  # duplicates
    keys[0] = 2**63 - 1  # ties with the kernel's padding
    before = sort.launches
    got = sort.sort_pairs(keys.to(cuda))
    assert sort.launches == before + 1
    assert torch.equal(got.cpu(), sort.sort_keys(keys))


RADIX_SIZES = [0, 1, 2, 31, (1 << 14) + 1, 12289, (1 << 20) + 3, 1 << 24]


def _radix_checked(keys, key_bits):
    """The radix sort of ``keys`` (on a card), held bit for bit against
    torch.sort; the input is left as it was, and the sort counts one
    launch from 2 keys up."""
    want = torch.sort(keys).values
    before, kept = radix.launches, keys.clone()
    got = radix.sort_keys(keys, key_bits)
    torch.cuda.synchronize()
    assert radix.launches == before + (keys.shape[0] > 1)
    assert torch.equal(got, want)
    assert torch.equal(keys, kept)


@pytest.mark.cuda
@pytest.mark.parametrize("n", RADIX_SIZES)
def test_radix_sort_matches_torch_sort(cuda, n):
    """Full-range int64, negatives included (the sketch's hashes), at 64
    bits; and flipped values below 2^62 - 1 with sentinels (k = 31) at 62:
    one partial tile, ragged last tiles, count's batch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    full = torch.randint(-(2**63), 2**63 - 1, (n,), device=cuda, generator=gen)
    full[: n // 4] = full[n // 4 : 2 * (n // 4)].clone()  # duplicates
    _radix_checked(full, 64)
    k31 = torch.randint(0, 2**62 - 1, (n,), device=cuda, generator=gen) ^ -(1 << 63)
    k31[: n // 5] = SENTINEL_KEY
    _radix_checked(k31, 62)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 11, 16, 21, 31, 32])
def test_radix_sort_of_k1_keys_at_2k_bits(cuda, k):
    """K1's own keys of reads with N runs (sentinels), sorted on their
    low 2k bits as count sorts them."""
    rng = np.random.default_rng(k)
    n = (1 << 20) - 37
    lanes, inv = _wire(rng, n, 1 << 20)
    keys, _ = extract.extract_keys(lanes.to(cuda), inv.to(cuda), k, n)
    assert bool((keys == SENTINEL_KEY).any())
    _radix_checked(keys, 2 * k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sentinels", "equal", "descending"])
@pytest.mark.parametrize("key_bits", [62, 64])
@pytest.mark.parametrize("n", [5000, (1 << 20) + 3])
def test_radix_sort_of_uniform_and_reversed_input(cuda, kind, key_bits, n):
    """Tiles of one digit (all sentinels, all equal) take the agent's
    short circuit; a descending input moves every key."""
    if kind == "sentinels":
        keys = torch.full((n,), SENTINEL_KEY, dtype=torch.int64, device=cuda)
    elif kind == "equal":
        keys = torch.full((n,), -(1 << 63) + 12345, dtype=torch.int64, device=cuda)
    else:
        keys = (torch.arange(n, 0, -1, device=cuda) * 7919) ^ -(1 << 63)
    _radix_checked(keys, key_bits)


@pytest.mark.cuda
def test_sort_pairs_above_its_cluster_takes_the_radix_sort(cuda):
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, (1 << 14) + 1, dtype=np.int64)).to(cuda)
    k4, before = sort.launches, radix.launches
    got = sort.sort_pairs(keys)
    assert (sort.launches, radix.launches) == (k4, before + 1)
    assert torch.equal(got, torch.sort(keys).values)


@pytest.mark.cuda
def test_joins_on_the_card_match_the_cpu(cuda):
    rng = np.random.default_rng(9)
    d = keys_from_u64(np.unique(rng.integers(0, 1 << 16, 5000, dtype=np.uint64)))
    q = keys_from_u64(rng.integers(0, 1 << 16, 7000, dtype=np.uint64))
    valid = torch.from_numpy(rng.random(7000) < 0.9)
    assert torch.equal(setops.membership(q, valid, d), setops.membership(q.to(cuda), valid.to(cuda), d.to(cuda)).cpu())
    for a, b in zip(setops.classify_join(q, d), setops.classify_join(q.to(cuda), d.to(cuda))):
        assert torch.equal(a, b.cpu())
    assert int(setops.intersection_size(d, d[::2].contiguous())) == int(
        setops.intersection_size(d.to(cuda), d[::2].contiguous().to(cuda))
    )
    e = d[:0]
    for q_, d_ in ((q, e), (e, d), (e, e)):
        got = setops.classify_join(q_.to(cuda), d_.to(cuda))
        assert not got[0].any() and not got[1].any()
        assert got[0].shape == q_.shape and got[1].shape == d_.shape
    for a_, b_ in ((d, e), (e, d), (e, e)):  # sorted unique sides only
        assert int(setops.intersection_size(a_.to(cuda), b_.to(cuda))) == 0


@pytest.mark.cuda
def test_pinned_ring_stages_the_cpu_batches(cuda, tmp_path, monkeypatch):
    """``staging.staged_batches`` on the card packs each batch into the
    pinned ring and copies it without blocking: with every batch held
    on the card before any is read (so each ring buffer is packed again
    while earlier copies may still run), the batches equal the CPU's."""
    from orion_kmer_tpu_torch import staging
    from orion_kmer_tpu_torch.host import _prefetch

    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("ACGTN"), size=int(rng.integers(50, 3000)))) for _ in range(40)]
    path = tmp_path / "in.fa"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    monkeypatch.setenv("ORION_KMER_THREADS", "4")  # four pack threads a batch
    got = list(_prefetch(staging.staged_batches(path, 21, True, 4096, cuda)))
    exp = list(staging.staged_batches(path, 21, True, 4096, torch.device("cpu")))
    assert len(got) == len(exp) > 3 * staging.PinnedRing.SLOTS
    for (gl, gi, gs, gn), (el, ei, es, en) in zip(got, exp):
        assert (gs, gn) == (es, en) and gl.device.type == "cuda"
        assert torch.equal(gl.cpu(), el) and torch.equal(gi.cpu(), ei)


@pytest.mark.cuda
@pytest.mark.parametrize("threads", ["1", "4"])
def test_query_stream_on_the_card_matches_the_oracle(cuda, tmp_path, monkeypatch, threads):
    """``engine.query_hits`` on the card (each batch and its record starts
    packed into the pinned ring, the hits read one batch late) against the
    codec oracle and the CPU path, with chunks and batches small enough
    that records span both, and a DB that holds the all-ones value (k =
    32 T^32, the sentinel), which no invalid window may match."""
    from orion_kmer_tpu_torch import engine, host

    k = 32
    rng = np.random.default_rng(int(threads))
    genome = rng.choice(list("ACGT"), 20_000)
    reads = []
    for i in range(600):
        n = int(rng.integers(1, 400)) if i % 50 else int(rng.integers(2000, 9000))
        p = int(rng.integers(0, genome.shape[0] - n))
        s = genome[p : p + n].copy()
        s[rng.random(n) < 0.005] = "N"
        reads.append("".join(s))
    reads += ["T" * 40, "A" * 33]
    path = tmp_path / "r.fq"
    path.write_text("".join(f"@q{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)))
    db = np.unique(np.concatenate([
        codec.extract_kmers_np(codec.seq_to_codes("".join(genome).encode()), k),
        np.array([0, 0xFFFF_FFFF_FFFF_FFFF], np.uint64),
    ]))
    monkeypatch.setenv("ORION_KMER_BATCH", "8192")
    monkeypatch.setenv("ORION_KMER_THREADS", threads)
    monkeypatch.setattr(host, "CHUNK_BYTES", 1 << 15)
    ids, lens, hits = engine.query_hits(db, path, k, cuda)
    want = [int(np.isin(codec.extract_kmers_np(codec.seq_to_codes(s.encode(), normalize=False), k), db).sum())
            for s in reads]
    assert ids == [b"q%d" % i for i in range(len(reads))] and lens == [len(s) for s in reads]
    assert hits.tolist() == want and want[-2:] == [9, 2]
    cpu = engine.query_hits(db, path, k, torch.device("cpu"))
    assert cpu[0] == ids and np.array_equal(cpu[2], hits)
    expect = [b"q%d" % i for i, (s, h) in enumerate(zip(reads, want)) if h >= 5 and len(s) >= k]
    assert engine.query_file(db, path, k, 5, cuda) == expect


@pytest.mark.cuda
def test_fetch_table_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """``staging.fetch_table`` (the sign flipped on the card, both planes
    copied into pinned memory at once) against ``u64_from_keys`` /
    ``.cpu()``: alone, with the arrays of one fetch kept intact by the
    next; on a table that spills (``DEVICE_TABLE_MAX`` small); on the
    sharded table and the one-shot sharded count.  The card's fetch does
    not go through ``Tensor.cpu``."""
    from orion_kmer_tpu_torch import engine, staging
    from orion_kmer_tpu_torch.keys import u64_from_keys
    from orion_kmer_tpu_torch.parallel import ShardedCountTable, make_mesh
    from orion_kmer_tpu_torch.parallel.sharded import sharded_count

    rng = np.random.default_rng(13)
    vals = np.sort(rng.choice(1 << 62, size=300_001, replace=False).astype(np.uint64))
    vals[-1] = np.uint64(0xFFFF_FFFF_FFFF_FFFF)
    keys = keys_from_u64(vals).to(cuda)
    counts = torch.from_numpy(rng.integers(1, 1 << 40, size=vals.shape[0])).to(cuda)
    want = u64_from_keys(keys), counts.cpu().numpy()
    batches = []
    for _ in range(8):
        b = rng.integers(0, 4, size=20_000, dtype=np.uint8)
        b[rng.random(20_000) < 0.01] = 255
        batches.append(b)
    cpu = torch.device("cpu")
    cpu_table = engine.DeviceCountTable(21, cpu)
    for b in batches:
        cpu_table.update(b)
    want_table = cpu_table.result()
    want_sharded = sharded_count(batches[0], batches[0] > 3, 21, make_mesh(3, cpu))

    def not_on_the_card(*a, **kw):
        raise AssertionError("the card's fetch took the plain path")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "cpu", not_on_the_card)
        got = staging.fetch_table(keys, counts)
        other = staging.fetch_table(keys[:1000].flip(0), counts[:1000])
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert np.array_equal(got[0], vals) and got[0].dtype == np.uint64 and got[1].dtype == np.int64
    assert np.array_equal(other[0], vals[:1000][::-1])
    empty = staging.fetch_table(keys[:0], counts[:0])
    assert empty[0].shape == empty[1].shape == (0,)

    monkeypatch.setattr(engine.DeviceCountTable, "DEVICE_TABLE_MAX", 30_000)
    monkeypatch.setattr(engine.DeviceCountTable, "FLUSH_WINDOWS", 1 << 15)
    table = engine.DeviceCountTable(21, cuda)
    for b in batches:
        table.update(b)
    got = table.result()
    assert table.stats["spills"] >= 3
    assert np.array_equal(got[0], want_table[0]) and np.array_equal(got[1], want_table[1])
    sharded_table = ShardedCountTable(21, make_mesh(3, cuda))
    for b in batches:
        sharded_table.update(b)
    got = sharded_table.result()
    assert np.array_equal(got[0], want_table[0]) and np.array_equal(got[1], want_table[1])
    got = sharded_count(batches[0], batches[0] > 3, 21, make_mesh(3, cuda))
    assert np.array_equal(got[0], want_sharded[0]) and np.array_equal(got[1], want_sharded[1])
