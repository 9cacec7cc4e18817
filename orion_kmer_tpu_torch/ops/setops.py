"""Exact set joins on int64 key sets: the torch counterparts of
``orion_kmer_tpu/ops/setops.py``.

Every join is one stable merge (K2, ``merge.py``) of the DB side, which
is sorted unique, with the query side, sorted: the DB is ``a`` and comes
first among equal keys, and the payload carries each row's origin (a
query's position, or ``-1 - row`` for a DB row).  Because the DB is
unique and heads its run, a query row is a member iff the head of its run
is a DB row, and a DB row is hit iff the next row has its key and is a
query.  The head of a query row's run, if it is a DB row, is the last DB
row before it, and the merge keeps the DB's order: the c-th DB row of the
merged order is DB row c - 1, so a prefix count of the DB rows (a
cumsum, one pass) and a gather of the DB's keys find it.  The JAX
version needs a forward cummax and a backward cummin to find a DB row
anywhere in a run, because its bitonic merge is not stable.  (torch's
CUDA cummax scans one long row in a single thread block: over the
~2^25 merged rows of one query batch it took 82.8 ms, the cumsum and
gather 1.2 ms, on an NVIDIA H100 80GB HBM3 at 700 W;
``tools/torch_query_stages.py``.)

Query rows go back to query order by a scatter into a buffer with one
spare slot, which takes every row that must not land: no compaction, no
host sync.  ``membership_sorted`` keeps the JAX version's compaction
(K3), since its queries arrive sorted and leave in merge order.

Invalid queries never match, not even a DB entry that equals the
sentinel (a genuine T^32 in a hand-made DB at k = 32).
"""

from __future__ import annotations

import torch

from ..keys import SENTINEL_KEY
from .compact import compact, compact_positions
from .merge import merge


def _merged(db_keys, q_sorted, q_tags):
    """K2 merge of the sorted-unique DB with ascending queries tagged
    ``q_tags`` (>= 0).  Returns (keys, tags, hit) in merged order: DB rows
    carry the tag -1 - row, and ``hit`` marks the query rows whose key is
    in the DB."""
    db_tags = -1 - torch.arange(db_keys.shape[0], device=db_keys.device)
    keys, tags = merge(db_keys, q_sorted, db_tags, q_tags, caller="join")
    return keys, tags, _member_rows(db_keys, keys, tags)


def _member_rows(db_keys, keys, tags):
    """The query rows of a merged join whose key is in the DB: those whose
    last DB row before them (DB row ``n_db - 1``, where ``n_db`` counts
    the DB rows up to them) has their key."""
    is_db = tags < 0
    if db_keys.shape[0] == 0:
        return torch.zeros_like(is_db)
    n_db = torch.cumsum(is_db, 0)
    last = db_keys[(n_db - 1).clamp_(min=0)]
    return ~is_db & (n_db > 0) & (last == keys)


def _scatter_true(rows, hit, n: int):
    """bool[n], True at ``rows[hit]`` (rows index 0..n-1 where hit)."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=rows.device)
    out[torch.where(hit, rows, n)] = True
    return out[:n]


def member_positions(db_keys, q_sorted, q_pos, n: int):
    """bool[n]: True at ``q_pos[i]`` iff ``q_sorted[i]`` is in the DB.

    db_keys: sorted unique int64 keys; q_sorted: ascending int64 query
    keys; q_pos: their positions in 0..n-1."""
    _, tags, hit = _merged(db_keys, q_sorted, q_pos)
    return _scatter_true(tags, hit, n)


def membership(q_keys, q_valid, db_keys):
    """For each query, is it in the DB?  (JAX ``setops.membership``.)

    q_keys: int64 keys in any order; q_valid: bool, invalid queries never
    match; db_keys: sorted unique int64 keys.  Returns bool[len(q_keys)]
    in query order."""
    nq = q_keys.shape[0]
    (vkeys, vpos), n_valid = compact_positions(q_keys, q_valid)
    m = int(n_valid)
    skeys, order = torch.sort(vkeys[:m])
    return member_positions(db_keys, skeys, vpos[:m][order], nq)


def membership_sorted(q_keys, q_valid, db_keys):
    """Membership for queries that are sorted unique over a valid prefix
    (the classify case).  The join is a pure merge, and the query rows
    leave it in input order through one compaction (K3)."""
    nq = q_keys.shape[0]
    qk = torch.where(q_valid, q_keys, SENTINEL_KEY)
    _, tags, hit = _merged(db_keys, qk, torch.zeros_like(qk))
    (member,), _ = compact([hit.to(torch.int64)], tags >= 0)
    return (member[:nq] == 1) & q_valid


def classify_join(q_keys, db_keys):
    """One merge answers both directions of the classify join: for every
    query row (the concatenated k-mers of many references, in any order,
    duplicates allowed), is it in the DB (the input count table, sorted
    unique), and for every DB row, is it hit by a query?

    Returns (member_q bool[len(q_keys)], member_db bool[len(db_keys)])."""
    skeys, order = torch.sort(q_keys)
    keys, tags, hit = _merged(db_keys, skeys, order)
    member_q = _scatter_true(tags, hit, q_keys.shape[0])
    is_db = tags < 0
    db_hit = torch.zeros_like(is_db)
    db_hit[:-1] = is_db[:-1] & ~is_db[1:] & (keys[1:] == keys[:-1])
    member_db = _scatter_true(-1 - tags, db_hit, db_keys.shape[0])
    return member_q, member_db


def intersection_size(a, b):
    """|A intersect B| of two sorted-unique key sets, as a 0-d int64
    tensor: each key occurs at most once per side, so a shared key is an
    equal adjacent pair of the merge."""
    keys, _ = merge(a, b, caller="join")
    return (keys[1:] == keys[:-1]).sum()


def union_runs(buf, lengths):
    """The union of ascending unique int64 runs that lie back to back at
    the front of ``buf``, ``lengths`` long: (keys, heads), every key of
    every run in ascending order and the mask of the first of each.

    The runs merge pairwise, level by level, by K2 (caller ``union``):
    ~6 levels for 50 runs, each key read and written once a level, from
    ``buf`` into one spare buffer of its size and back in turn.  Each merge
    writes at an even offset, where K2's output starts on a 16-byte
    boundary, so ``buf`` holds ``sum(lengths) + len(lengths)`` keys; the odd
    run of a level is copied across.  Empty runs take no part."""
    runs = [r for r in buf[: sum(lengths)].split(list(lengths)) if r.shape[0]]
    dst = torch.empty_like(buf)
    while len(runs) > 1:
        merged, off = [], 0
        for pair in (runs[i : i + 2] for i in range(0, len(runs), 2)):
            n = sum(r.shape[0] for r in pair)
            out = dst[off : off + n]
            if len(pair) == 2:
                merge(*pair, caller="union", out=out)
            else:
                out.copy_(pair[0])
            merged.append(out)
            off += n + n % 2
        runs, buf, dst = merged, dst, buf
    keys = runs[0] if runs else buf[:0]
    heads = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    torch.ne(keys[1:], keys[:-1], out=heads[1:])
    return keys, heads
