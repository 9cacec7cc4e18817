"""cohort command group: the entrez-tool / hybrid-finder CLI drivers.

The port's copy of ``orion_kmer_tpu/commands/cohort.py``, over the
port's own ``cohort`` package; host-only, so ``--device`` is not used.

Parity targets (the reference's user-facing Python scripts):
  * ``cohort search``    -> entrez-tool/entrez_query.py:540-837 ``main``:
    SRA search (default), BioProject / PubMed search, from-BioProject /
    from-PubMed link walks, --hybrid-only paginated filtering, YAML
    config merge (CLI overrides config; ref:631-642), JSON --output.
  * ``cohort validate``  -> the --validate mode (ref:660-670).
  * ``cohort hybrid``    -> find_hybrid_samples.py:132-195 (manifest ->
    hybrid biosamples JSON with batch workers + checkpointing).
  * ``cohort summarize`` -> summarize_hybrid.py:8-109 (hybrid JSON ->
    4-column TSV).

Networked modes construct the real eutils transport / pysradb-backed
metadata client lazily; tests inject offline fakes through
``make_tool``/``make_client`` (monkeypatched factory seams).
"""

from __future__ import annotations

import json
import logging

from ..errors import ContextError, GenericError

logger = logging.getLogger("orion_kmer_tpu_torch.cohort")


def make_tool(email: str, api_key: str | None):
    """Factory seam: build the EntrezQueryTool (tests monkeypatch this)."""
    from ..cohort.client import default_client
    from ..cohort.entrez import EntrezQueryTool

    try:
        client = default_client()
    except Exception:  # noqa: BLE001 - pysradb optional; eutils-only still works
        client = None
    return EntrezQueryTool(email=email, api_key=api_key, metadata_client=client)


def make_client():
    """Factory seam for the pysradb-backed metadata client."""
    from ..cohort.client import default_client

    return default_client()


def _merged_params(args) -> dict:
    """YAML config under CLI overrides (entrez_query.py:631-642)."""
    config: dict = {}
    if args.config:
        from ..cohort.entrez import load_config

        try:
            config = load_config(args.config) or {}
        except OSError as e:
            raise ContextError(f"Failed to load config file: {args.config!r}", e) from e
    return {
        "environment": args.environment or config.get("environment"),
        "pathogens": args.pathogens or config.get("pathogens"),
        "host": args.host or config.get("host"),
        "keywords": args.keywords or config.get("keywords", []),
        "email": args.email or config.get("email", "user@example.com"),
        "api_key": args.api_key or config.get("api_key"),
    }


def _write_output(results, output_path) -> None:
    if not output_path:
        return
    from ..ingest.compress import TextOut

    with TextOut(output_path) as f:
        json.dump(results, f, indent=2)
    logger.info("Results saved to %s", output_path)


def run_cohort_search(args) -> None:
    p = _merged_params(args)
    tool = make_tool(p["email"], p["api_key"])

    if args.from_bioproject:
        logger.info("Fetching SRA runs from BioProject: %s", args.from_bioproject)
        uids = tool.get_sra_from_bioproject(args.from_bioproject)
        results = tool.fetch_sra_details(uids[: args.max_results]) if uids else []
        _print_rows(results)
        _write_output(results, args.output_file)
        return

    if args.from_pubmed:
        logger.info("Fetching SRA data linked to PMID: %s", args.from_pubmed)
        uids = tool.get_sra_from_pubmed(args.from_pubmed)
        results = tool.fetch_sra_details(uids[: args.max_results]) if uids else []
        _print_rows(results)
        _write_output(results, args.output_file)
        return

    if args.bioproject:
        if not (p["keywords"] or p["environment"] or p["pathogens"]):
            raise GenericError("--keywords (or config) required for BioProject search")
        terms = list(p["keywords"] or [])
        if p["environment"]:
            terms.append(p["environment"])
        if p["pathogens"]:
            terms.extend(p["pathogens"])
        query = " AND ".join(f'"{t}"' for t in terms)
        uids = tool.search_bioproject(query, retmax=args.max_results)
        results = [{"bioproject_uid": u} for u in uids]
        _print_rows(results)
        _write_output(results, args.output_file)
        return

    if args.pubmed:
        if not p["keywords"]:
            raise GenericError("--keywords required for PubMed search")
        query = " AND ".join(f'"{k}"' for k in p["keywords"])
        results = tool.search_pubmed(query, retmax=args.max_results)
        if args.get_sra and results:
            all_sra: list[str] = []
            for article in results[:5]:  # ref:720 limits to first 5
                pmid = article.get("pmid")
                if pmid:
                    all_sra.extend(tool.get_sra_from_pubmed(pmid))
            if all_sra:
                sra_rows = tool.fetch_sra_details(
                    sorted(set(all_sra))[: args.max_results]
                )
                _print_rows(sra_rows)
        _print_rows(results)
        _write_output(results, args.output_file)
        return

    # SRA search mode (default; ref:633-636 defaults to SRA)
    has_short = not args.no_short_reads
    has_long = not args.no_long_reads
    if args.hybrid_only:
        # search the rarer long-read technology first (ref:646-651)
        has_short, has_long = False, True
    query = tool.build_sra_search_query(
        environment=p["environment"],
        pathogens=p["pathogens"],
        host=p["host"],
        keywords=p["keywords"],
        has_short_reads=has_short,
        has_long_reads=has_long,
    )
    logger.info("SRA query: %s", query)
    if args.hybrid_only:
        results = tool.find_hybrid_samples(query, max_results=args.max_results)
    else:
        uids, _total = tool.search_sra(query, retmax=args.max_results)
        results = tool.fetch_sra_details(uids)
    _print_rows(results)
    _write_output(results, args.output_file)


def _print_rows(rows) -> None:
    for row in rows:
        print(json.dumps(row, default=str))


def run_cohort_validate(args) -> None:
    p = _merged_params(args)
    tool = make_tool(p["email"], p["api_key"])
    any_invalid = False
    for acc in args.accessions:
        is_valid, message = tool.validate_accession(acc)
        status = "VALID" if is_valid else "INVALID"
        print(f"{acc}: {status} - {message}")
        any_invalid |= not is_valid
    if any_invalid and args.strict:
        raise GenericError("One or more accessions failed validation")


def run_cohort_hybrid(args) -> None:
    from ..cohort.find_hybrid import find_hybrid_samples

    results = find_hybrid_samples(
        input_file=args.input_file,
        output_file=args.output_file,
        limit=args.limit,
        workers=args.workers,
        client=make_client(),
        batch_size=args.batch_size,
    )
    logger.info("Found %d hybrid samples.", len(results))


def run_cohort_summarize(args) -> None:
    from ..cohort.summarize import summarize_hybrid

    rows = summarize_hybrid(
        input_file=args.input_file,
        output_file=args.output_file,
        client=make_client(),
        batch_size=args.batch_size,
    )
    logger.info("Summarized %d biosamples.", len(rows))


def add_cohort_parser(sub) -> None:
    """Wire the `cohort` command group into the main CLI parser."""
    co = sub.add_parser(
        "cohort",
        help="NCBI/SRA metadata tooling (entrez-tool + hybrid finder)",
    )
    cosub = co.add_subparsers(dest="cohort_command", required=True)

    # search (entrez_query.py main modes)
    se = cosub.add_parser("search", help="Search SRA/BioProject/PubMed")
    mode = se.add_mutually_exclusive_group(required=False)
    mode.add_argument("--sra", action="store_true", help="Search SRA (default)")
    mode.add_argument("--bioproject", action="store_true", help="Search BioProject")
    mode.add_argument("--pubmed", action="store_true", help="Search PubMed")
    mode.add_argument(
        "--from-bioproject", metavar="PRJNA", help="SRA runs of a BioProject"
    )
    mode.add_argument("--from-pubmed", metavar="PMID", help="SRA linked to a PMID")
    _common_search_args(se)
    se.add_argument(
        "--no-short-reads", action="store_true", help="Drop the short-read term"
    )
    se.add_argument(
        "--no-long-reads", action="store_true", help="Drop the long-read term"
    )
    se.add_argument(
        "--hybrid-only",
        action="store_true",
        help="Require both short- and long-read runs per sample",
    )
    se.add_argument(
        "--get-sra", action="store_true", help="PubMed mode: fetch linked SRA"
    )
    se.add_argument(
        "-m", "--max-results", type=int, default=20, help="Maximum results"
    )
    se.add_argument("-o", "--output-file", default=None, help="Output JSON path")
    se.set_defaults(cohort_fn=run_cohort_search)

    # validate
    va = cosub.add_parser("validate", help="Validate NCBI accessions")
    va.add_argument("accessions", nargs="+", metavar="ACC")
    va.add_argument(
        "--strict", action="store_true", help="Exit nonzero if any is invalid"
    )
    _common_search_args(va)
    va.set_defaults(cohort_fn=run_cohort_validate)

    # hybrid (find_hybrid_samples.py pipeline)
    hy = cosub.add_parser(
        "hybrid", help="Find biosamples with both short- and long-read runs"
    )
    hy.add_argument(
        "-i",
        "--input-file",
        default="data_metagenome.json.gz",
        help="Run-record manifest (JSON/.gz)",
    )
    hy.add_argument(
        "-o",
        "--output-file",
        default="hybrid_biosamples.json",
        help="Output hybrid-biosamples JSON",
    )
    hy.add_argument("--limit", type=int, default=None, help="Limit study count")
    hy.add_argument(
        "--workers", type=int, default=None, help="Worker threads (default: -t)"
    )
    hy.add_argument("--batch-size", type=int, default=50)
    hy.set_defaults(cohort_fn=run_cohort_hybrid)

    # summarize (summarize_hybrid.py)
    su = cosub.add_parser("summarize", help="Summarize hybrid biosamples to TSV")
    su.add_argument("-i", "--input-file", default="hybrid_biosamples.json")
    su.add_argument("-o", "--output-file", default="hybrid_data_summary.tsv")
    su.add_argument("--batch-size", type=int, default=50)
    su.set_defaults(cohort_fn=run_cohort_summarize)


def _common_search_args(p) -> None:
    p.add_argument("-c", "--config", default=None, help="YAML config file")
    p.add_argument("-e", "--environment", default=None, help="Sample environment")
    p.add_argument("-p", "--pathogens", nargs="+", default=None)
    p.add_argument("-H", "--host", dest="host", default=None, help="Host organism")
    p.add_argument("-k", "--keywords", nargs="+", default=None)
    p.add_argument("--email", default=None, help="NCBI contact email")
    p.add_argument("--api-key", default=None, help="NCBI API key")


def run_cohort(args, device=None) -> None:
    args.cohort_fn(args)
