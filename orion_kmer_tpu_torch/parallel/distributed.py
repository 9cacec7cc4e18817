"""Counting across processes: ``torch.distributed`` set-up and the
cross-process sharded count.

The torch counterpart of ``orion_kmer_tpu/parallel/distributed.py``.  The
shard axis spans every device of every process: each rank holds one or
more local shards (by default its share of the host's cards), and the
global shard ids are rank-major.  The environment contract is the JAX
package's: ``ORION_KMER_COORDINATOR`` (host:port of rank 0),
``ORION_KMER_NUM_PROCESSES`` and ``ORION_KMER_PROCESS_ID``; without them,
or with one process, nothing is initialized.

Backend: ``nccl`` when the ranks run on CUDA and every rank has a lead
card of its own, ``gloo`` otherwise (CPU ranks, or ranks that share a
card, which NCCL refuses).  The choice is made once, at init, from the
device asked for and every rank's host name and card count, and is
logged.  The NCCL group moves tensors of each rank's lead card, its first
local card, so cross-process traffic leaves from and arrives there; gloo
moves CPU tensors only, so there the routed segments of CUDA ranks cross
through pinned host buffers.
"""

from __future__ import annotations

import collections
import datetime
import json
import logging
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..engine import to_device
from ..keys import u64_from_keys
from ..ops.compact import partition
from ..ops.count import rle_sorted
from ..ops.extract import extract_keys
from .mesh import make_mesh
from .sharded import fetch_counts, shard_blocks
from .streaming import _pack_blocks

logger = logging.getLogger("orion_kmer_tpu_torch.parallel.distributed")


def choose_backend(device, ranks_per_host: int, n_cards: int | None = None) -> str:
    """``nccl`` when the ranks run on CUDA and each of the (at most)
    ``ranks_per_host`` ranks of a host has a lead card of its own among
    ``n_cards`` (default: the visible cards), else ``gloo``."""
    if n_cards is None:
        n_cards = torch.cuda.device_count()
    if torch.device(device).type == "cuda" and n_cards >= ranks_per_host:
        return "nccl"
    return "gloo"


def local_devices(hostnames: list[str], rank: int, n_cards: int) -> list[int]:
    """The card indices of ``rank``, given every rank's host name: local
    rank j of the m ranks on its host takes cards j, j + m, j + 2m, ...
    So a lone rank takes every card, and one rank per card takes card j.
    With fewer cards than local ranks, ranks share cards round-robin."""
    if n_cards < 1:
        raise RuntimeError('no CUDA device is visible (pass device="cpu" for CPU ranks)')
    peers = [r for r, host in enumerate(hostnames) if host == hostnames[rank]]
    j, m = peers.index(rank), len(peers)
    return list(range(j, n_cards, m)) if m < n_cards else [j % n_cards]


def rank_devices(device="cuda") -> list[torch.device]:
    """The devices of this rank's shards: ``device`` itself when it is the
    CPU or names a card, else this rank's share of the visible cards
    (``local_devices``; the host names are gathered over the group)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return [device]
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is visible (pass device="cpu" for CPU ranks)')
    hostnames = [None] * dist.get_world_size()
    dist.all_gather_object(hostnames, socket.gethostname())
    return [torch.device("cuda", i) for i in local_devices(hostnames, dist.get_rank(), torch.cuda.device_count())]


def rank_device(device="cuda") -> torch.device:
    """The lead device of this rank: the first of ``rank_devices``."""
    return rank_devices(device)[0]


def maybe_initialize_distributed(device="cuda", timeout: float = 120.0) -> bool:
    """Initialize ``torch.distributed`` from the environment when it is
    configured for more than one process; returns True if a multi-process
    group is active.  ``device``: where the ranks will compute, which
    decides the backend (``choose_backend``).  Before the group forms, the
    ranks post their host name and card count in the coordinator's store,
    so every rank makes the same choice and an nccl rank makes its lead
    card current."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = os.environ.get("ORION_KMER_COORDINATOR")
    if not coordinator:
        return False
    num_processes = int(os.environ.get("ORION_KMER_NUM_PROCESSES", "1"))
    process_id = int(os.environ.get("ORION_KMER_PROCESS_ID", "0"))
    if num_processes <= 1:
        return False
    host, port = coordinator.rsplit(":", 1)
    wait = datetime.timedelta(seconds=timeout)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0, timeout=wait)
    n_cards = torch.cuda.device_count()
    store.set(f"orion_kmer/host/{process_id}", f"{n_cards} {socket.gethostname()}")
    posted = [store.get(f"orion_kmer/host/{r}").decode().split(" ", 1) for r in range(num_processes)]
    hostnames = [name for _, name in posted]
    ranks_per_host = max(collections.Counter(hostnames).values())
    backend = choose_backend(device, ranks_per_host, min(int(cards) for cards, _ in posted))
    if backend == "nccl":
        torch.cuda.set_device(local_devices(hostnames, process_id, n_cards)[0])
    dist.init_process_group(backend, store=store, world_size=num_processes, rank=process_id, timeout=wait)
    logger.info(
        "torch.distributed initialized: process %d/%d via %s, backend %s "
        "(%d visible cards, at most %d ranks a host, ranks on %s)",
        process_id, num_processes, coordinator, backend, n_cards, ranks_per_host, torch.device(device).type,
    )
    return True


def _to_comm(t: torch.Tensor, comm: torch.device) -> torch.Tensor:
    """``t`` where the process group sends it from: on the lead card for
    nccl; for gloo as it is on the CPU, else in a pinned host buffer."""
    if t.device == comm:
        return t
    if comm.type == "cuda":
        return t.to(comm, non_blocking=True)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _all_gather_ragged(t: torch.Tensor, comm: torch.device) -> torch.Tensor:
    """The concatenation of every rank's 1-d int64 ``t`` (lengths differ),
    on ``comm``, in rank order."""
    t = _to_comm(t, comm)
    world = dist.get_world_size()
    sizes = [torch.zeros(1, dtype=torch.int64, device=comm) for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([t.shape[0]], dtype=torch.int64, device=comm))
    sizes = [int(s) for s in sizes]
    padded = torch.zeros(max(max(sizes), 1), dtype=torch.int64, device=comm)
    padded[: t.shape[0]] = t
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    return torch.cat([p[:m] for p, m in zip(parts, sizes)])


def multihost_sharded_count(codes, invalid, k: int, device="cuda", stats: dict | None = None, devices=None):
    """One sharded count step across every shard of every process.

    All processes pass the same full (codes, invalid) host arrays.  This
    rank's shards sit on ``devices`` (what ``make_mesh`` takes; by default
    ``rank_devices(device)``, the rank's share of the host's cards); the
    global shard ids are rank-major, S in all.  Each local shard extracts
    its block (K1) and splits its keys by owner (``ops.compact.partition``:
    one K3 pass for all S global destinations); one all-gather of the local rows of
    routed counts gives every rank the S x S table, so every split size is
    known without a second round trip.  Segments for a shard of this rank
    are peer copies; the rest cross in one ``all_to_all_single``, in
    (source shard, owner shard) order, with split sizes per rank.  Each
    owner sorts and run-length encodes what it received, and only those
    small results are gathered, so every process returns the same (vals
    uint64, counts int64), value sorted.  ``stats``, if given, is filled
    with the traffic of this call."""
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh(devices=devices) if devices is not None else rank_devices(device)
    if dist.get_backend() == "nccl":
        if any(d.type != "cuda" for d in mesh):
            raise ValueError("multihost_sharded_count: the nccl backend needs CUDA ranks")
        comm = torch.device("cuda", torch.cuda.current_device())
    else:
        comm = torch.device("cpu")

    n_local = _all_gather_ragged(torch.tensor([len(mesh)], dtype=torch.int64), comm).tolist()
    S, first = sum(n_local), sum(n_local[:rank])
    owner_rank = np.repeat(np.arange(world), n_local)
    mine = np.arange(first, first + len(mesh))

    blk_codes, blk_invalid, stride = shard_blocks(codes, invalid, k, S)
    block = -(-stride // 32) * 32  # the wire format packs 32 positions a word
    lanes, inv_words = _pack_blocks(blk_codes.reshape(S, -1)[mine], blk_invalid.reshape(S, -1)[mine], block)
    bufs, counts = [], []
    for s, dev in enumerate(mesh):
        keys, _ = extract_keys(to_device(lanes[s], dev), to_device(inv_words[s], dev), k, block)
        b, c = partition(keys, S)
        bufs.append(b)
        counts.append(c)
    local_rows = torch.from_numpy(fetch_counts(counts, mesh).reshape(-1))
    table = _all_gather_ragged(local_rows, comm).cpu().numpy().reshape(S, S)

    # what leaves this rank: for each other rank q, every local source's
    # segments for q's shards, in (source, owner) order
    send = [
        _to_comm(bufs[s][d][: int(table[g, d])], comm)
        for q in range(world) if q != rank
        for s, g in enumerate(mine)
        for d in np.flatnonzero(owner_rank == q)
    ]
    theirs = owner_rank != rank
    in_splits = [0 if q == rank else int(table[mine][:, owner_rank == q].sum()) for q in range(world)]
    out_splits = [0 if p == rank else int(table[owner_rank == p][:, ~theirs].sum()) for p in range(world)]
    send = torch.cat(send) if send else torch.empty(0, dtype=torch.int64, device=comm)
    recv = torch.empty(sum(out_splits), dtype=torch.int64, device=comm)
    dist.all_to_all_single(recv, send, output_split_sizes=out_splits, input_split_sizes=in_splits)

    # cut the received keys by (source, owner); add this rank's own
    # segments; each owner sorts, so the order of arrival does not matter
    remote_sources = np.flatnonzero(theirs)
    pieces = torch.split(recv, table[np.ix_(remote_sources, mine)].reshape(-1).tolist())
    results = []
    for o, dev in enumerate(mesh):
        d = first + o
        segments = [bufs[s][d][: int(table[g, d])].to(dev, non_blocking=True) for s, g in enumerate(mine)]
        segments += [pieces[i * len(mesh) + o].to(dev, non_blocking=True) for i in range(len(remote_sources))]
        received = torch.cat(segments)
        ukeys, ucnt = rle_sorted(
            torch.sort(received).values, torch.full((), received.shape[0], dtype=torch.int64, device=dev)
        )
        results.append((_to_comm(ukeys, comm), _to_comm(ucnt, comm)))
    all_keys = _all_gather_ragged(torch.cat([u for u, _ in results]), comm)
    all_counts = _all_gather_ragged(torch.cat([c for _, c in results]), comm)
    vals = u64_from_keys(all_keys)
    order = np.argsort(vals, kind="stable")

    if stats is not None:
        positions = max(int(codes.shape[0]), 1)
        crossed = int(table[owner_rank[:, None] != owner_rank[None, :]].sum())
        stats.update(
            {
                "k": k,
                "route": "int64-a2a",
                "backend": dist.get_backend(),
                "n_shards": S,
                "n_processes": world,
                "positions": positions,
                "route_dispatches": 1,
                "a2a_bytes_per_position": round(8 * int(table.sum()) / positions, 3),
                # the bytes that left their process
                "ici_bytes_per_position": round(8 * crossed / positions, 3),
            }
        )
    return vals[order], all_counts.cpu().numpy()[order]


def run_ranks(worker: str, args: list[list[str]], work_dir, timeout: float) -> list[str]:
    """Run the Python source ``worker`` as ``len(args)`` processes that form
    one group through the environment contract, rank r with the argv
    ``args[r]``.  Returns each rank's standard output; raises with the
    stderr of a rank that failed, or when the shared deadline passes.
    The workers are always reaped: an orphan would wait in the group's
    rendezvous."""
    work_dir = Path(work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)
    script = work_dir / "rank_worker.py"
    script.write_text(worker)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo_root = str(Path(__file__).resolve().parent.parent.parent)
    procs = []
    for pid, argv in enumerate(args):
        env = dict(os.environ)
        if any(name == "lo" for _, name in socket.if_nameindex()):
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank is on this host
        env.update(
            ORION_KMER_COORDINATOR=f"127.0.0.1:{port}",
            ORION_KMER_NUM_PROCESSES=str(len(args)),
            ORION_KMER_PROCESS_ID=str(pid),
            PYTHONPATH=repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, str(script), *map(str, argv)],
                env=env,
                cwd=repo_root,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{len(args)} ranks timed out after {timeout:.0f}s; workers killed") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, (_so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {pid} failed:\n{se.decode()[-3000:]}")
    return [so.decode() for so, _se in outs]


_SMOKE_WORKER = '''
import json, sys
import numpy as np
import torch.distributed as dist

from orion_kmer_tpu_torch import codec
from orion_kmer_tpu_torch.ops import compact, extract
from orion_kmer_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    multihost_sharded_count,
    rank_devices,
)
from orion_kmer_tpu_torch.parallel.mesh import make_mesh

device, shards = sys.argv[1], int(sys.argv[2])
assert maybe_initialize_distributed(device), "distributed init did not trigger"
assert dist.get_world_size() == 2, dist.get_world_size()
mesh = make_mesh(shards, rank_devices(device))

rng = np.random.default_rng(77)  # same seed in both processes
codes = rng.integers(0, 4, size=4096, dtype=np.uint8)
codes[rng.random(4096) < 0.02] = 255
edge = codec.seq_to_codes(b"T" * 40)

counts_done = []
for name, k, c in (("k=9", 9, codes), ("k=21", 21, codes), ("k=32", 32, codes), ("T*40, k=32", 32, edge)):
    stats = {}
    vals, counts = multihost_sharded_count(c, c > 3, k, device, stats=stats, devices=mesh)
    exp_v, exp_c = np.unique(codec.extract_kmers_np(c, k), return_counts=True)
    np.testing.assert_array_equal(vals, exp_v)
    np.testing.assert_array_equal(counts, exp_c)
    counts_done.append({"count": name, "unique": int(vals.shape[0]), "stats": stats})
print(json.dumps({"rank": dist.get_rank(), "devices": [str(d) for d in mesh], "counts": counts_done,
                  "launches": {"K1": extract.launches, "K3": compact.launches, "K3 modes": compact.by_mode}}))
dist.destroy_process_group()
'''


def run_two_process_smoke(work_dir, timeout: float = 240.0, device="cuda", shards=1) -> dict:
    """Spawn two processes that form one group through the environment
    contract (gloo, or nccl where each has a lead card) and each check,
    against the numpy oracle, the cross-process sharded count of a seeded
    4,096-position stream at k = 9, 21 and 32 and of the k = 32 ``T*40``
    edge.  ``shards``: the shards of each rank, one int for both or one
    per rank (they take the rank's share of the cards round-robin).
    Raises on any failure; returns {"processes": 2, "shards": [...],
    "unique": N (k = 9), "a2a_stats": {...} (k = 9), "counts": [...],
    "launches": [...], "devices": [...]}."""
    per_rank = [shards, shards] if isinstance(shards, int) else list(shards)
    outs = run_ranks(_SMOKE_WORKER, [[device, n] for n in per_rank], work_dir, timeout)
    try:
        r0, r1 = (json.loads(out.strip().splitlines()[-1]) for out in outs)
    except (IndexError, json.JSONDecodeError):
        raise RuntimeError(f"unexpected smoke outputs: {outs!r}") from None
    if (r0["rank"], r1["rank"]) != (0, 1):
        raise RuntimeError(f"unexpected smoke outputs: {outs!r}")
    if [c["unique"] for c in r0["counts"]] != [c["unique"] for c in r1["counts"]]:
        raise RuntimeError(f"processes disagree on unique counts: {outs!r}")
    return {
        "processes": 2,
        "shards": per_rank,
        "unique": r0["counts"][0]["unique"],
        "a2a_stats": r0["counts"][0]["stats"],
        "counts": r0["counts"],
        "launches": [r0["launches"], r1["launches"]],
        "devices": [r0["devices"], r1["devices"]],
    }
