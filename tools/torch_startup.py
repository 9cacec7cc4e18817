#!/usr/bin/env python3
"""Cold start of the port's CLI, stage by stage: a ladder of fresh processes.

    python3 tools/torch_startup.py [--roots DIR[,DIR...]] [--reps 5] [--ladders 1] [--gbp 0.5]
                                   [--commands count,serve] [--only 2,11] [--seed N]

Each rung is a ``python -c CODE`` in a new process, run from each
checkout of ``--roots`` (default: this one; the process's working
directory is the checkout, so its ``orion_kmer_tpu_torch`` is the one
imported), ``--reps`` times, the checkouts taking turns rep by rep.  A
rung's code is the previous rung's plus one stage, so the difference of
two rungs' medians is the cost of that stage:

  0 the interpreter (``pass``); 1 ``import numpy`` and
  ``orion_kmer_tpu_torch.cli``; 2 ``import torch``; 3
  ``torch.cuda.is_available()``; 4 the CUDA context (``torch.empty(1,
  device="cuda")``, synchronize); 5 ``_kernels.lib()`` (its cached
  build: the sources' hash and the ``ctypes`` load); 6
  ``native.available()`` (the parser's load); 7 every command module and
  ``server``; 8 ``engine.DeviceCountTable(31, "cuda").warm()``; 9 two
  ``engine.count_file`` of the reads in that process, each timed in it
  (the first grows the caching allocator to the flush's size and makes
  the pinned slots); 10 the CLI: ``count -k 31`` of a 24-base file and,
  with ``count`` in ``--commands``, ``count -k 31 -m 2 --histogram`` of
  the reads (``query -c 10`` and ``sketch --scaled 1000`` with those in
  ``--commands``), each through ``cli.main``, with its peak RSS; ``serve`` in
  ``--commands``: ``serve --warm-k 31`` from process start until its
  socket exists (ready), then a ``shutdown``; 11 ``import torch`` in a
  process that parses the reads on a thread of its own beside it
  (``host.native_chunks`` at -t 8 and at -t 1), that only reads the file
  on a thread, that starts another process to parse it, and alone, each
  with the import's own time and, for the parse, the positions it had
  parsed when the import ended.  ``--only 2,11`` runs those rungs
  alone.  Every rung but 11 and ``serve`` also gives its
  ``exit``: the time from the end of its code (a stamp the child prints;
  for the CLI, ``cli.main``'s return) to the end of the process as its
  parent sees it.

The reads are ``chip_smoke.py`` phase 5's E. coli-like reads (``--gbp``,
made once under build/startup/); ``query`` joins them with phase 6's DB,
built once by the first checkout.  Before the ladders each checkout runs
every rung's code once, untimed, to build its kernels and parser.

Prints the facts that decide what a start-up can cut: the card's name,
power limit and persistence mode and the driver version (``nvidia-smi``),
``torch.__version__``, ``torch.version.cuda``,
``torch.cuda.get_arch_list()``, ``CUDA_MODULE_LOADING`` as torch leaves
it, and the size of the CUDA JIT cache (``$CUDA_CACHE_PATH`` or
``~/.nv/ComputeCache``) before and after each ladder.  Then one JSON
line per rung and checkout: every wall, the median, the distance between
the quartiles, the least and the most (the same of its other numbers),
and each stage's cost: a rung's median less the one before.  ``--ladders 2`` runs the whole ladder twice, to show what the
page cache (of ``libtorch_cuda``) does for the second.  ``--device cpu``
runs the rungs that need no card on the CPU, as a rehearsal of the tool:
none of its numbers is a device number.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
KMER = 31

# the port's CLI through cli.main, which prints the monotonic time of its
# return (CLOCK_MONOTONIC is one clock for every process of the machine)
# and the process's peak resident set, read every 10 ms from
# /proc/self/statm as chip_smoke.py phase 5 reads it
CLI = (
    "import os, sys, threading, time\n"
    "page, peak, done = os.sysconf('SC_PAGE_SIZE'), [0], threading.Event()\n"
    "def sample():\n"
    "    while not done.is_set():\n"
    "        with open('/proc/self/statm') as f:\n"
    "            peak[0] = max(peak[0], int(f.read().split()[1]) * page)\n"
    "        time.sleep(0.01)\n"
    "sampler = threading.Thread(target=sample, daemon=True)\n"
    "sampler.start()\n"
    "from orion_kmer_tpu_torch.cli import main\n"
    "rc = main(sys.argv[1:])\n"
    "t = time.monotonic()\n"
    "done.set()\n"
    "sampler.join()\n"
    "print('returned', t, 'peak_rss', peak[0], flush=True)\n"
    "sys.exit(rc)\n"
)


def stages(device: str) -> list[tuple[str, str]]:
    """The ladder's stages as (name, code); rung i runs stages 0..i."""
    card = device == "cuda"
    return [
        ("0 interpreter", "pass"),
        ("1 numpy, cli", "import numpy\nimport orion_kmer_tpu_torch.cli"),
        ("2 import torch", "import torch"),
        ("3 cuda.is_available", "assert torch.cuda.is_available()" if card else "pass"),
        ("4 context", f"torch.empty(1, device={device!r})\nif {card}: torch.cuda.synchronize()"),
        ("5 _kernels.lib", "from orion_kmer_tpu_torch import _kernels\n" + ("_kernels.lib()" if card else "pass")),
        ("6 native.available", "from orion_kmer_tpu_torch.ingest import native\nassert native.available()"),
        ("7 command modules",
         "from orion_kmer_tpu_torch.commands import build, classify, cohort, compare, count, profile, query, sketch\n"
         "from orion_kmer_tpu_torch.server import run_serve"),
        ("8 warm k=31",
         f"from orion_kmer_tpu_torch import engine\nengine.DeviceCountTable({KMER}, {device!r}).warm()\n"
         f"if {card}: torch.cuda.synchronize()"),
    ]


def count_twice(fq: Path, device: str) -> str:
    """Rung 9's last stage: two count_file of the reads, each timed in the
    child, printed as one JSON line."""
    return (
        "import json, time\ntimes = []\n"
        "for _ in range(2):\n"
        "    t0 = time.monotonic()\n"
        f"    engine.count_file({str(fq)!r}, {KMER}, {device!r})\n"
        "    times.append(time.monotonic() - t0)\n"
        "print(json.dumps({'first_s': times[0], 'second_s': times[1]}))"
    )


# rung 11: torch's import beside other work on the host.  With T (argv[2])
# a number, a thread parses the reads (host.native_chunks on the CLI's
# parser threads at -t T) from just before the import, and the positions
# parsed by its end are printed; with T = 0 a thread only reads the file, in the parse's chunks;
# with T = "process" another process parses it (-t 0); with T = "-" the
# import runs alone.
BESIDE = (
    "import json, os, sys, threading, time\n"
    "os.environ['ORION_KMER_THREADS'] = sys.argv[2]\n"
    "from orion_kmer_tpu_torch import host\n"
    "t0 = time.monotonic()\n"
    "if sys.argv[2] == '-':\n"
    "    import torch\n"
    "    print(json.dumps({{'import_torch_s': time.monotonic() - t0}}))\n"
    "elif sys.argv[2] == 'process':\n"
    "    import subprocess\n"
    "    code = 'import sys; from orion_kmer_tpu_torch import host; all(host.native_chunks(sys.argv[1], {k}))'\n"
    "    child = subprocess.Popen([sys.executable, '-c', code, sys.argv[1]])\n"
    "    import torch\n"
    "    print(json.dumps({{'import_torch_s': time.monotonic() - t0}}))\n"
    "    child.wait()\n"
    "elif sys.argv[2] == '0':\n"
    "    def read():\n"
    "        with open(sys.argv[1], 'rb') as f:\n"
    "            while f.read(host.CHUNK_BYTES):\n"
    "                pass\n"
    "    reader = threading.Thread(target=read)\n"
    "    reader.start()\n"
    "    import torch\n"
    "    print(json.dumps({{'import_torch_s': time.monotonic() - t0}}))\n"
    "    reader.join()\n"
    "else:\n"
    "    parsed = [0, 0]\n"
    "    def parse():\n"
    "        for p in host.native_chunks(sys.argv[1], {k}, threads=host.parse_threads()):\n"
    "            parsed[0] += p.codes.shape[0]\n"
    "            parsed[1] += 1\n"
    "    parser = threading.Thread(target=parse)\n"
    "    parser.start()\n"
    "    import torch\n"
    "    n, chunks = parsed\n"
    "    print(json.dumps({{'import_torch_s': time.monotonic() - t0, 'parsed_positions': n, 'parsed_chunks': chunks}}))\n"
    "    parser.join()\n"
).format(k=KMER)


def run_child(root: Path, args: list[str], env: dict) -> tuple[float, str]:
    """A fresh process from ``root``: (wall s from spawn to its end as seen
    here, its standard output, with the monotonic time at which its code
    ended printed last)."""
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, *args], cwd=root, env=env, capture_output=True, text=True, timeout=900)
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: {args[:2]} failed ({proc.returncode}): {proc.stderr[-3000:]}")
    return wall, proc.stdout


def stamped(code: str) -> str:
    """``code`` followed by a print of the monotonic time it ended at."""
    return code + "\nimport time as _t\nprint('returned', _t.monotonic(), flush=True)"


def returned(stdout: str) -> float:
    return float(stdout.split("returned ")[-1].split()[0])


def run_cli(root: Path, argv, env: dict) -> dict:
    """The CLI through cli.main in a fresh process: its wall, and the exit
    (from cli.main's return to the end of the process)."""
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", CLI, *map(str, argv)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=900)
    end = time.monotonic()
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: {argv} failed ({proc.returncode}): {proc.stderr[-3000:]}")
    peak = int(proc.stdout.split("peak_rss ")[-1].split()[0])
    return {"wall_s": end - t0, "exit_s": end - returned(proc.stdout), "peak_rss_bytes": peak}


def run_serve(root: Path, device: str, work: Path, env: dict) -> dict:
    """``serve --warm-k 31`` in a fresh process: the time from spawn until
    its socket exists, then a shutdown and the time to its end."""
    sock = work / f"serve_{os.getpid()}.sock"
    sock.unlink(missing_ok=True)
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-c", CLI, "--device", device, "serve", "--socket", str(sock),
                             "--warm-k", str(KMER)], cwd=root, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        while not sock.exists():
            if proc.poll() is not None:
                raise RuntimeError(f"{root}: serve ended ({proc.returncode}): {proc.stderr.read()[-3000:]}")
            if time.monotonic() - t0 > 300:
                raise RuntimeError(f"{root}: serve not ready after 300 s")
            time.sleep(0.002)
        ready = time.monotonic() - t0
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(str(sock))
        c.sendall(b'{"argv": ["shutdown"]}\n')
        c.recv(1 << 16)
        c.close()
        t1 = time.monotonic()
        proc.wait(timeout=120)
        return {"ready_s": ready, "shutdown_s": time.monotonic() - t1}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


def jit_cache_bytes() -> int | None:
    """Bytes in the CUDA JIT cache, or None where there is none."""
    path = Path(os.environ.get("CUDA_CACHE_PATH") or Path.home() / ".nv" / "ComputeCache")
    if not path.is_dir():
        return None
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def facts(device: str, env: dict) -> dict:
    """The card, the driver and torch as a fresh process sees them."""
    out = {"CUDA_MODULE_LOADING before torch": os.environ.get("CUDA_MODULE_LOADING")}
    if device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,persistence_mode,driver_version",
                              "--format=csv,noheader"], capture_output=True, text=True, check=True)
        out["nvidia-smi name, power.limit, persistence_mode, driver_version"] = smi.stdout.strip()
    code = (
        "import json, os, torch\n"
        f"torch.empty(1, device={device!r})\n"
        "print(json.dumps({'torch': torch.__version__, 'torch.version.cuda': torch.version.cuda,\n"
        f"    'arch_list': torch.cuda.get_arch_list() if {device == 'cuda'} else None,\n"
        "    'CUDA_MODULE_LOADING after torch': os.environ.get('CUDA_MODULE_LOADING')}))"
    )
    out.update(json.loads(run_child(HERE, ["-c", code], env)[1].strip().splitlines()[-1]))
    return out


def summary(values: list[float], unit: str = "s") -> dict:
    q = statistics.quantiles(values, n=4) if len(values) > 1 else [values[0]] * 3
    return {f"median_{unit}": statistics.median(values), f"quartile_distance_{unit}": q[2] - q[0],
            f"min_{unit}": min(values), f"max_{unit}": max(values), f"values_{unit}": values}


def ladder(roots: list[Path], fq: Path, work: Path, reps: int, commands: list[str], device: str = "cuda",
           db: Path | None = None, only: set[str] | None = None) -> dict:
    """One ladder: {root: {rung: summary}}, the checkouts taking turns rep
    by rep.  ``fq``: the reads of rungs 9-11; ``db``: query's DB;
    ``only``: the rung numbers to run (default: all)."""
    env = dict(os.environ, ORION_KMER_SHARDS="0")
    steps = stages(device)
    tiny = work / "tiny.fa"
    tiny.write_bytes(b">t\nACGTACGTTGCAACGTACGTTGCA\n")
    rungs = []  # (name, kind, what)
    for i in range(len(steps)):
        rungs.append((steps[i][0], "code", "\n".join(code for _, code in steps[: i + 1])))
    rungs.append(("9 count_file x2", "code", "\n".join(code for _, code in steps) + "\n" + count_twice(fq, device)))
    rungs += [("11 torch's import alone", "beside", "-"),
              ("11 a parse beside torch's import, -t 8", "beside", "8"),
              ("11 a parse beside torch's import, -t 1", "beside", "1"),
              ("11 the file read beside torch's import", "beside", "0"),
              ("11 the parse in another process beside torch's import", "beside", "process")]
    dev = ["--device", device]
    out = work / "out"
    clis = {"10 cli count, 24 bases": dev + ["count", "-k", KMER, "-i", tiny, "-o", out.with_suffix(".tiny.tsv")]}
    if "count" in commands:
        clis["10 cli count -m 2 --histogram"] = dev + ["count", "-k", KMER, "-m", 2, "--histogram",
                                                       out.with_suffix(".hist"), "-i", fq, "-o", out.with_suffix(".tsv")]
    if "query" in commands:
        clis["10 cli query -c 10"] = dev + ["query", "-d", db, "-r", fq, "-c", 10, "-o", out.with_suffix(".ids")]
    if "sketch" in commands:
        clis["10 cli sketch --scaled 1000"] = dev + ["sketch", "-k", KMER, "--scaled", 1000, "-i", fq,
                                                     "-o", out.with_suffix(".sig")]
    rungs += [(name, "cli", argv) for name, argv in clis.items()]
    if "serve" in commands:
        rungs.append(("10 serve --warm-k 31: ready", "serve", None))
    if only:
        rungs = [r for r in rungs if r[0].split()[0] in only]
    result = {str(r): {} for r in roots}
    for name, kind, what in rungs:
        rows = {str(r): [] for r in roots}
        for rep in range(reps):
            for root in roots if rep % 2 == 0 else roots[::-1]:
                if kind == "code":
                    t0 = time.monotonic()
                    wall, stdout = run_child(root, ["-c", stamped(what)], env)
                    row = {"wall_s": wall, "exit_s": t0 + wall - returned(stdout)}
                    if name.startswith("9"):
                        row.update(json.loads(stdout.strip().splitlines()[-2]))
                elif kind == "beside":
                    wall, stdout = run_child(root, ["-c", BESIDE, str(fq), what], env)
                    row = {"wall_s": wall, **(json.loads(stdout) if stdout.strip() else {})}
                elif kind == "cli":
                    row = run_cli(root, what, env)
                else:
                    row = run_serve(root, device, work, env)
                rows[str(root)].append(row)
        for root, got in rows.items():
            key = "ready_s" if kind == "serve" else "wall_s"
            entry = summary([r[key] for r in got])
            for extra in ("first_s", "second_s", "exit_s", "shutdown_s", "import_torch_s", "parsed_positions",
                          "parsed_chunks", "peak_rss_bytes"):
                if extra in got[0]:
                    entry[extra] = summary([r[extra] for r in got], "s" if extra.endswith("_s") else "")
            result[root][name] = entry
    return result


def medians(rows: dict) -> dict:
    """{rung: {"wall_s": its median, each other number: its median}}."""
    out = {}
    for name, r in rows.items():
        out[name] = {"wall_s": r["median_s"]}
        for key, v in r.items():
            if isinstance(v, dict):
                out[name][key] = v["median_s" if key.endswith("_s") else "median_"]
    return out


def differences(rows: dict) -> dict:
    """Each prefix rung's median less the one before it: that stage's cost."""
    names = [n for n in rows if n[0].isdigit() and int(n.split()[0]) <= 9]
    out = {}
    for prev, cur in zip(names, names[1:]):
        out[cur] = rows[cur]["median_s"] - rows[prev]["median_s"]
    if "9 count_file x2" in rows:
        r = rows["9 count_file x2"]
        out["9: first count_file less the second"] = r["first_s"]["median_s"] - r["second_s"]["median_s"]
    return out


def prepare(work: Path, gbp: float, seed: int, commands: list[str], first_root: Path, device: str):
    """The reads (and query's DB) under ``work``, made once."""
    sys.path.insert(0, str(HERE))
    import numpy as np

    import chip_smoke

    fq = work / f"reads_{gbp}_{seed}.fastq"
    db = work / f"refs_{gbp}_{seed}.db"
    if not fq.exists() or ("query" in commands and not db.exists()):
        rng = np.random.default_rng(seed)
        _, _, genome, _ = chip_smoke.write_reads_fastq(np, fq, rng, gbp)
        if "query" in commands:
            refs = chip_smoke.write_references(np, work, rng, genome)
            run_cli(first_root, ["--device", device, "build", "-k", KMER, "-g",
                                 *(path for path, _ in refs.values()), "-o", db], dict(os.environ))
    return fq, db


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", default=str(HERE), help="comma-separated checkouts, taking turns")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ladders", type=int, default=1)
    ap.add_argument("--gbp", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--commands", default="count,serve", help="CLI rungs beyond the 24-base count: "
                    "any of count, query, sketch, serve")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a rehearsal of the tool, with no device number")
    ap.add_argument("--only", default="", help="comma-separated rung numbers to run (default: every rung)")
    args = ap.parse_args()
    roots = [Path(r).resolve() for r in args.roots.split(",")]
    commands = [c for c in args.commands.split(",") if c]
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch_startup: no CUDA device")
    work = HERE / "build" / "startup"
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, ORION_KMER_SHARDS="0")
    print(json.dumps({"facts": facts(args.device, env), "roots": [str(r) for r in roots]}), flush=True)
    fq, db = prepare(work, args.gbp, args.seed, commands, roots[0], args.device)
    for root in roots:  # untimed: builds this checkout's kernels and parser
        run_child(root, ["-c", "\n".join(code for _, code in stages(args.device))], env)
    try:
        for n in range(args.ladders):
            before = jit_cache_bytes()
            rows = ladder(roots, fq, work, args.reps, commands, args.device, db,
                          {r for r in args.only.split(",") if r} or None)
            after = jit_cache_bytes()
            for root, by_rung in rows.items():
                for name, entry in by_rung.items():
                    print(json.dumps({"ladder": n + 1, "root": root, "rung": name, **entry}), flush=True)
                print(json.dumps({"ladder": n + 1, "root": root, "stage_costs_s": differences(by_rung)}), flush=True)
            print(json.dumps({"ladder": n + 1, "jit_cache_bytes_before": before, "jit_cache_bytes_after": after,
                              "device": args.device}), flush=True)
    finally:
        for p in work.glob("out.*"):
            p.unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
