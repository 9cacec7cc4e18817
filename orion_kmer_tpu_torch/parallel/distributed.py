"""Counting across processes: ``torch.distributed`` set-up and the
cross-process sharded count.

The torch counterpart of ``orion_kmer_tpu/parallel/distributed.py``.  Each
process is one shard.  The environment contract is the JAX package's:
``ORION_KMER_COORDINATOR`` (host:port of rank 0), ``ORION_KMER_NUM_PROCESSES``
and ``ORION_KMER_PROCESS_ID``; without them, or with one process, nothing
is initialized.

Backend: ``nccl`` when the ranks run on CUDA and every rank has a card of
its own, ``gloo`` otherwise (CPU ranks, or ranks that share a card, which
NCCL refuses).  The choice is made once, from the device asked for, the
world size and the card count, and is logged.  gloo moves CPU tensors
only, so there the routed segments of CUDA ranks cross through pinned
host buffers.
"""

from __future__ import annotations

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
from ..host import pack_for_transfer
from ..keys import u64_from_keys
from ..ops.count import rle_sorted
from ..ops.extract import extract_keys
from .sharded import route_keys, shard_blocks

logger = logging.getLogger("orion_kmer_tpu_torch.parallel.distributed")


def choose_backend(device, num_processes: int) -> str:
    """``nccl`` when the ranks run on CUDA with a card each, else ``gloo``."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``device`` itself when it is the CPU or
    names a card, else the visible cards round-robin by rank."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is visible (pass device="cpu" for CPU ranks)')
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def maybe_initialize_distributed(device="cuda", timeout: float = 120.0) -> bool:
    """Initialize ``torch.distributed`` from the environment when it is
    configured for more than one process; returns True if a multi-process
    group is active.  ``device``: where the ranks will compute, which
    decides the backend (``choose_backend``)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = os.environ.get("ORION_KMER_COORDINATOR")
    if not coordinator:
        return False
    num_processes = int(os.environ.get("ORION_KMER_NUM_PROCESSES", "1"))
    process_id = int(os.environ.get("ORION_KMER_PROCESS_ID", "0"))
    if num_processes <= 1:
        return False
    backend = choose_backend(device, num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout),
    )
    logger.info(
        "torch.distributed initialized: process %d/%d via %s, backend %s "
        "(%d visible cards, ranks on %s)",
        process_id, num_processes, coordinator, backend,
        torch.cuda.device_count() if torch.cuda.is_available() else 0, torch.device(device).type,
    )
    return True


def _for_backend(t: torch.Tensor, comm_cuda: bool) -> torch.Tensor:
    """``t`` where the process group can send it: as it is when the
    backend moves tensors of its device, else in a pinned host buffer."""
    if comm_cuda or t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _all_gather_ragged(t: torch.Tensor, comm_cuda: bool) -> torch.Tensor:
    """The concatenation of every rank's 1-d int64 ``t`` (lengths differ),
    on this rank's communication device, in rank order."""
    t = _for_backend(t, comm_cuda)
    world = dist.get_world_size()
    sizes = [torch.zeros(1, dtype=torch.int64, device=t.device) for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device))
    sizes = [int(s) for s in sizes]
    padded = torch.zeros(max(max(sizes), 1), dtype=torch.int64, device=t.device)
    padded[: t.shape[0]] = t
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    return torch.cat([p[:m] for p, m in zip(parts, sizes)])


def multihost_sharded_count(codes, invalid, k: int, device="cuda", stats: dict | None = None):
    """One sharded count step across every process of the group, one
    shard per process.

    All processes pass the same full (codes, invalid) host arrays; rank r
    extracts block r (K1), splits its keys by owner (``route_keys``, K3),
    and the ranks exchange first the counts, then the exact segments
    (``all_to_all_single`` with split sizes).  Each rank sorts and
    run-length encodes its hash range, and only those small results are
    gathered, so every process returns the same (vals uint64, counts
    int64), value sorted.  ``stats``, if given, is filled with the traffic
    of this call."""
    S, rank = dist.get_world_size(), dist.get_rank()
    dev = rank_device(device)
    comm_cuda = dist.get_backend() == "nccl"
    if comm_cuda and dev.type != "cuda":
        raise ValueError("multihost_sharded_count: the nccl backend needs CUDA ranks")
    blk_codes, blk_invalid, stride = shard_blocks(codes, invalid, k, S)
    block = -(-stride // 32) * 32
    row = np.where(blk_invalid.reshape(S, -1)[rank], 255, blk_codes.reshape(S, -1)[rank]).astype(np.uint8)
    lanes, inv_words = pack_for_transfer(row, block)
    keys, _ = extract_keys(to_device(lanes, dev), to_device(inv_words, dev), k, block)
    bufs, counts = route_keys(keys, S)

    send_counts = _for_backend(counts, comm_cuda)
    recv_counts = torch.empty_like(send_counts)
    dist.all_to_all_single(recv_counts, send_counts)
    n_send, n_recv = send_counts.tolist(), recv_counts.tolist()
    send = _for_backend(torch.cat([buf[:m] for buf, m in zip(bufs, n_send)]), comm_cuda)
    recv = torch.empty(sum(n_recv), dtype=torch.int64, device=send.device)
    dist.all_to_all_single(recv, send, output_split_sizes=n_recv, input_split_sizes=n_send)

    received = recv.to(dev)
    ukeys, ucnt = rle_sorted(
        torch.sort(received).values,
        torch.full((), received.shape[0], dtype=torch.int64, device=dev),
    )
    all_keys = _all_gather_ragged(ukeys, comm_cuda)
    all_counts = _all_gather_ragged(ucnt, comm_cuda)
    vals = u64_from_keys(all_keys)
    order = np.argsort(vals, kind="stable")

    if stats is not None:
        routed = torch.tensor([sum(n_send), sum(n_send) - n_send[rank]], dtype=torch.int64, device=send_counts.device)
        dist.all_reduce(routed)
        sent, crossed = routed.tolist()
        positions = max(int(codes.shape[0]), 1)
        stats.update(
            {
                "k": k,
                "route": "int64-a2a",
                "backend": dist.get_backend(),
                "n_shards": S,
                "n_processes": S,
                "positions": positions,
                "route_dispatches": 1,
                "a2a_bytes_per_position": round(8 * sent / positions, 3),
                # the bytes that left their process
                "ici_bytes_per_position": round(8 * crossed / positions, 3),
            }
        )
    return vals[order], all_counts.cpu().numpy()[order]


_SMOKE_WORKER = '''
import json, sys
import numpy as np
import torch.distributed as dist

from orion_kmer_tpu_torch import codec
from orion_kmer_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    multihost_sharded_count,
)

out, device = sys.argv[1:]
assert maybe_initialize_distributed(device), "distributed init did not trigger"
assert dist.get_world_size() == 2, dist.get_world_size()

k = 9
rng = np.random.default_rng(77)  # same seed in both processes
codes = rng.integers(0, 4, size=4096, dtype=np.uint8)
codes[rng.random(4096) < 0.02] = 255
invalid = codes > 3

stats = {}
vals, counts = multihost_sharded_count(codes, invalid, k, device, stats=stats)

exp_v, exp_c = np.unique(codec.extract_kmers_np(codes, k), return_counts=True)
np.testing.assert_array_equal(vals, exp_v)
np.testing.assert_array_equal(counts, exp_c)
with open(out, "w") as f:
    f.write(f"ok {dist.get_rank()} {vals.shape[0]} " + json.dumps(stats))
dist.destroy_process_group()
'''


def run_two_process_smoke(work_dir, timeout: float = 240.0, device="cuda") -> dict:
    """Spawn two processes that form one group through the environment
    contract (gloo, or nccl where each has a card) and each check one
    cross-process sharded count against the numpy oracle.  Raises on any
    failure; returns {"processes": 2, "unique": N, "a2a_stats": {...}}.
    """
    work_dir = Path(work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)
    worker = work_dir / "distributed_smoke_worker.py"
    worker.write_text(_SMOKE_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo_root = str(Path(__file__).resolve().parent.parent.parent)
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        if any(name == "lo" for _, name in socket.if_nameindex()):
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # both ranks are on this host
        env.update(
            ORION_KMER_COORDINATOR=f"127.0.0.1:{port}",
            ORION_KMER_NUM_PROCESSES="2",
            ORION_KMER_PROCESS_ID=str(pid),
            PYTHONPATH=repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, str(worker), str(work_dir / f"smoke_out{pid}"), str(device)],
                env=env,
                cwd=repo_root,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    # one shared deadline across both processes, and the workers are
    # always reaped: an orphan would wait in the group's rendezvous
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"distributed smoke timed out after {timeout:.0f}s; workers killed") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, (_so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"distributed smoke process {pid} failed:\n{se.decode()[-3000:]}")
    r0 = (work_dir / "smoke_out0").read_text()
    r1 = (work_dir / "smoke_out1").read_text()
    if not (r0.startswith("ok 0 ") and r1.startswith("ok 1 ")):
        raise RuntimeError(f"unexpected smoke outputs: {r0!r} {r1!r}")
    if r0.split()[2] != r1.split()[2]:
        raise RuntimeError(f"processes disagree on unique count: {r0!r} {r1!r}")
    return {
        "processes": 2,
        "unique": int(r0.split()[2]),
        "a2a_stats": json.loads(r0.split(None, 3)[3]),
    }
