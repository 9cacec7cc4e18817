"""Command-line interface of the port: every subcommand of the JAX
package's CLI (``count``, ``build``, ``compare``, ``query``,
``classify``, ``sketch``, ``sketch-compare``, ``profile``, ``serve``,
``cohort``) and the global ``--server PATH`` client flag.

The same flags, help, ``-t``/``-v`` and error rendering as
``orion_kmer_tpu/cli.py`` (which mirrors the reference clap CLI,
orion-kmer/src/cli.rs, and main.rs:7-16: log the outermost error, exit
1).  ``count`` and ``build`` spread over several shards with
``ORION_KMER_SHARDS=N`` (``engine._make_count_table``).

``--device`` picks where the work runs: ``cuda`` (the default) or
``cpu``.  Without a visible card the default fails with one error line
and exit 1, for every subcommand; the port never moves to the CPU unless
asked.  ``--server PATH`` sends the rest of the argv to a running
``serve`` instead, before anything else is parsed.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys

from .errors import OrionKmerError
from .utils import get_num_threads, setup_logging, spans
from .version import __version__

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
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="Where the k-mer work runs (default: cuda; fails without a card)",
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

    # compare (cli.rs:80-95)
    cp = sub.add_parser("compare", help="Compare two k-mer databases")
    cp.add_argument("--db1", required=True, help="First k-mer database file")
    cp.add_argument("--db2", required=True, help="Second k-mer database file")
    cp.add_argument(
        "-o", "--output-file", required=True, help="Output file for comparison stats (JSON)"
    )

    # query (cli.rs:97-130)
    q = sub.add_parser("query", help="Query short reads against a k-mer database")
    q.add_argument(
        "-d", "--database", dest="database_file", required=True, help="K-mer database"
    )
    q.add_argument(
        "-r", "--reads", dest="reads_file", required=True, help="Short-read file (FASTQ)"
    )
    q.add_argument(
        "-o", "--output-file", required=True, help="Output file for matching read IDs"
    )
    q.add_argument(
        "-c",
        "--min-hits",
        type=int,
        default=1,
        help="Minimum number of k-mer hits to report a read",
    )

    # classify (cli.rs:132-185)
    cl = sub.add_parser(
        "classify",
        help="Classify sequences against k-mer databases and report coverage statistics",
    )
    cl.add_argument("-i", "--input-file", required=True, help="Input FASTA/FASTQ file")
    cl.add_argument(
        "-d",
        "--databases",
        dest="database_files",
        nargs="+",
        action="extend",
        required=True,
        help="One or more k-mer database files (.db)",
    )
    cl.add_argument(
        "-o", "--output-file", required=True, help="Output file for classification JSON"
    )
    cl.add_argument(
        "-k",
        "--kmer-size",
        type=int,
        default=None,
        help="Optional k-mer size to validate against databases",
    )
    cl.add_argument(
        "--min-kmer-frequency",
        type=int,
        default=1,
        help="Minimum input k-mer frequency for depth calculation",
    )
    cl.add_argument(
        "--min-coverage",
        type=float,
        default=0.0,
        help="Minimum reference breadth of coverage to include a reference",
    )
    cl.add_argument(
        "--output-tsv", default=None, help="Optional TSV summary output path"
    )

    # sketch (FracMinHash, BASELINE.json config 3)
    sk = sub.add_parser("sketch", help="FracMinHash sketch of FASTA/FASTQ files")
    sk.add_argument("-k", "--kmer-size", type=int, required=True)
    sk.add_argument(
        "-i", "--input-files", nargs="+", action="extend", required=True,
        help="Input FASTA/FASTQ files (one sketch per file)",
    )
    sk.add_argument("-o", "--output-file", required=True, help="Output .sig JSON")
    sk.add_argument(
        "--scaled", type=int, default=1000,
        help="Keep k-mers with hash < 2^64/scaled (FracMinHash)",
    )
    sk.add_argument(
        "--num", type=int, default=0,
        help="Optional bottom-N MinHash cap on top of the scaled filter",
    )

    skc = sub.add_parser(
        "sketch-compare", help="Pairwise Jaccard/containment between sketches"
    )
    skc.add_argument(
        "-s", "--sketches", dest="sketch_files", nargs="+", action="extend",
        required=True, help="Sketch .sig files",
    )
    skc.add_argument("-o", "--output-file", required=True, help="Output JSON")

    # profile (multi-sample cohort profiling, BASELINE.json config 4)
    pr = sub.add_parser(
        "profile", help="Profile many samples from a cohort manifest in one run"
    )
    pr.add_argument("-k", "--kmer-size", type=int, required=True)
    pr.add_argument(
        "--manifest", required=True,
        help='JSON manifest: [{"sample": name, "files": [fastx...]}, ...]',
    )
    pr.add_argument("-o", "--output-file", required=True, help="Output JSON")
    pr.add_argument(
        "-d", "--databases", dest="database_files", nargs="+", action="extend",
        default=None, help="Optional k-mer databases to classify each sample against",
    )
    pr.add_argument(
        "--scaled", type=int, default=None,
        help="Optional FracMinHash scale: include a sketch per sample",
    )
    pr.add_argument(
        "--min-coverage", type=float, default=0.0,
        help="Minimum reference breadth to report (classification mode)",
    )

    # serve (resident server: one process answers many requests)
    sv = sub.add_parser("serve", help="Run a persistent engine server on a unix socket")
    sv.add_argument("--socket", required=True, help="Unix socket path to listen on")
    sv.add_argument(
        "--warm-k",
        type=int,
        nargs="*",
        default=[],
        help="Pre-warm the count path for these k values at startup",
    )

    # cohort (entrez-tool + hybrid finder CLI drivers)
    from .commands.cohort import add_cohort_parser

    add_cohort_parser(sub)
    return p


def _extract_server_flag(argv: list[str]) -> tuple[str | None, list[str]]:
    """Pull a global --server PATH / --server=PATH out of raw argv.

    Handled before argparse so the remaining argv is forwarded to the
    server byte-exactly (re-serializing parsed args would be lossy)."""
    rest: list[str] = []
    path = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--server" and i + 1 < len(argv):
            path = argv[i + 1]
            i += 2
        elif a.startswith("--server="):
            path = a.split("=", 1)[1]
            i += 1
        else:
            rest.append(a)
            i += 1
    return path, rest


@contextlib.contextmanager
def _profiled(trace_dir: str, device):
    """Record a torch.profiler trace of the block into trace_dir, with the
    port's spans (``utils/spans.py``) under one ``cli.call`` root; the
    recorder is emptied after, since the trace holds them."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # every thread's ops and spans, the prefetch thread's too
    config = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, experimental_config=config) as prof:
        with spans.span("cli.call"):
            yield
    spans.take()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace.{os.getpid()}.json"))


def main(argv=None) -> int:
    """Run one command; its exit code.  The whole call is the ``cli.call``
    span where a caller's profiler records (a benchmark's window); with
    ``--trace`` the span opens once that profiler has started."""
    with spans.span("cli.call"):
        argv = list(sys.argv[1:]) if argv is None else [str(a) for a in argv]
        server_path, argv = _extract_server_flag(argv)
        if server_path is not None:
            from .server import forward

            return forward(server_path, argv)
        args = build_parser().parse_args(argv)
        setup_logging(args.verbose)

        # host worker threads (-t, 0 = all cores), read by the ingest
        # prefetch queue through ORION_KMER_THREADS
        os.environ["ORION_KMER_THREADS"] = str(get_num_threads(args.threads))

        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            print(
                "[ERROR orion_kmer_tpu] Error: no CUDA device is available "
                "(pass --device cpu to run on the CPU)",
                file=sys.stderr,
            )
            return 1
        device = torch.device(args.device)
        logger.info("Device: %s", device)

        from .commands import build, classify, cohort, compare, count, profile, query, sketch
        from .server import run_serve

        dispatch = {
            "serve": run_serve,
            "count": count.run_count,
            "build": build.run_build,
            "compare": compare.run_compare,
            "query": query.run_query,
            "classify": classify.run_classify,
            "sketch": sketch.run_sketch,
            "sketch-compare": sketch.run_sketch_compare,
            "profile": profile.run_profile,
            "cohort": cohort.run_cohort,
        }
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
