"""Command-line interface of the port: ``count`` and ``build``.

The same flags, help, ``-t``/``-v`` and error rendering as
``orion_kmer_tpu/cli.py`` (which mirrors the reference clap CLI,
orion-kmer/src/cli.rs, and main.rs:7-16: log the outermost error, exit
1).  The other subcommands of the JAX package are not ported yet, so
argparse rejects them (exit 2).

The device is resolved once: ``cuda`` when ``torch.cuda.is_available()``,
else ``cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys

from orion_kmer_tpu.errors import OrionKmerError
from orion_kmer_tpu.utils import get_num_threads, setup_logging
from orion_kmer_tpu.version import __version__

logger = logging.getLogger("orion_kmer_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="orion-kmer-tpu-torch",
        description="PyTorch/CUDA k-mer toolkit (capabilities of orion-kmer)",
    )
    p.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    p.add_argument(
        "-t",
        "--threads",
        type=int,
        default=0,
        help="Number of host worker threads (0 for all logical cores)",
    )
    p.add_argument(
        "-v",
        "--verbose",
        action="count",
        default=0,
        help="Verbosity level (e.g., -v, -vv)",
    )
    p.add_argument(
        "--trace",
        default=None,
        metavar="DIR",
        help="Write a torch.profiler trace of the run to this directory",
    )
    sub = p.add_subparsers(dest="command", required=True)

    # count (cli.rs:38-61)
    c = sub.add_parser("count", help="Count k-mers in FASTA/FASTQ files")
    c.add_argument("-k", "--kmer-size", type=int, required=True, help="The length of the k-mer")
    c.add_argument(
        "-i",
        "--input-files",
        nargs="+",
        action="extend",
        required=True,
        help="One or more input FASTA/FASTQ files (.gz/.xz/.zst supported)",
    )
    c.add_argument(
        "-o",
        "--output-file",
        required=True,
        help="Output file for k-mer counts (kmer<TAB>count)",
    )
    c.add_argument(
        "-m", "--min-count", type=int, default=1, help="Minimum count to report a k-mer"
    )
    c.add_argument(
        "--histogram",
        default=None,
        help="Optional: write a multiplicity histogram (multiplicity<TAB>distinct k-mers)",
    )
    c.add_argument(
        "--checkpoint",
        default=None,
        help="Optional: checkpoint file for resumable multi-file counting",
    )

    # build (cli.rs:63-78)
    b = sub.add_parser("build", help="Build a unique k-mer database from genome assemblies")
    b.add_argument("-k", "--kmer-size", type=int, required=True, help="The length of the k-mer")
    b.add_argument(
        "-g",
        "--genomes",
        dest="genome_files",
        nargs="+",
        action="extend",
        required=True,
        help="One or more input genome assembly files (FASTA)",
    )
    b.add_argument(
        "-o", "--output-file", required=True, help="Output path for the binary k-mer database"
    )
    b.add_argument(
        "--checkpoint",
        default=None,
        help="Optional: checkpoint file for resumable multi-genome builds",
    )
    return p


def resolve_device():
    """``cuda`` when a card is visible, else ``cpu``."""
    import torch

    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@contextlib.contextmanager
def _profiled(trace_dir: str, device):
    """Record a torch.profiler trace of the block into trace_dir."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace.{os.getpid()}.json"))


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else [str(a) for a in argv]
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose)

    # host worker threads (-t, 0 = all cores), read by the ingest
    # prefetch queue through ORION_KMER_THREADS
    os.environ["ORION_KMER_THREADS"] = str(get_num_threads(args.threads))

    from .commands import build, count

    dispatch = {"count": count.run_count, "build": build.run_build}
    device = resolve_device()
    logger.info("Device: %s", device)
    try:
        ctx = _profiled(args.trace, device) if args.trace else contextlib.nullcontext()
        with ctx:
            dispatch[args.command](args, device)
    except OrionKmerError as e:
        print(f"[ERROR orion_kmer_tpu] Error: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"[ERROR orion_kmer_tpu] Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
