"""The port's cohort tooling (orion_kmer_tpu_torch/cohort, commands/cohort)
against the JAX package's, offline, with the fakes of tests/test_cohort.py
and tests/test_cli_cohort.py injected into both: equal results, equal
files and equal stdout."""

import gzip
import json

import pytest

import orion_kmer_tpu.commands.cohort as jax_cmd
import orion_kmer_tpu_torch.commands.cohort as port_cmd
from orion_kmer_tpu.cli import main as jax_main
from orion_kmer_tpu.cohort import entrez as jax_entrez
from orion_kmer_tpu.cohort import find_hybrid as jax_fh
from orion_kmer_tpu.cohort import manifest as jax_manifest
from orion_kmer_tpu.cohort import platforms as jax_platforms
from orion_kmer_tpu.cohort import summarize as jax_summarize
from orion_kmer_tpu_torch.cohort import entrez as port_entrez
from orion_kmer_tpu_torch.cohort import find_hybrid as port_fh
from orion_kmer_tpu_torch.cohort import manifest as port_manifest
from orion_kmer_tpu_torch.cohort import platforms as port_platforms
from orion_kmer_tpu_torch.cohort import summarize as port_summarize

from .test_cli_cohort import FakeEutils, FakeMeta
from . import test_cohort
from .test_cohort import FakeClient, FakeTransport, _row
from .test_torch_count import port_cpu

ROWS = test_cohort.TestFindHybrid.ROWS + [_row("S4", "R6", None), _row("N/A", "R7", "MinION")]


@pytest.mark.parametrize(
    "model",
    ["Illumina MiSeq", "MinION", "GridION", "PacBio RS II", "NextSeq 500", "DNBSEQ-T7",
     "Ion Torrent PGM", "Unknown", None, 123, "promethion 24", "AB 5500xl"],
)
def test_classify_platform_matches_jax(model):
    assert port_platforms.classify_platform(model) == jax_platforms.classify_platform(model)


def test_find_hybrid_in_rows_matches_jax():
    got = port_fh.find_hybrid_in_rows(ROWS)
    assert got == jax_fh.find_hybrid_in_rows(ROWS)
    assert {h["biosample"] for h in got} == {"S1", "S3"}


@pytest.mark.parametrize("fail_times", [0, 2, 5])
def test_process_batch_retries_match_jax(fail_times):
    outs = []
    for mod in (jax_fh, port_fh):
        sleeps = []
        out = mod.process_batch(["PRJ1"], FakeClient(ROWS, fail_times=fail_times), sleep=sleeps.append)
        outs.append((out, sleeps))
    assert outs[0] == outs[1]


def test_find_hybrid_samples_end_to_end_matches_jax(tmp_path):
    studies = [{"study_accession": f"PRJ{i}"} for i in range(7)] + [{"other": 1}]
    inp = tmp_path / "data.json.gz"
    inp.write_bytes(gzip.compress(json.dumps(studies).encode()))
    results = []
    for name, mod in (("jax", jax_fh), ("port", port_fh)):
        out = tmp_path / f"{name}.json"
        res = mod.find_hybrid_samples(input_file=inp, output_file=out, client=FakeClient(ROWS),
                                      batch_size=2, workers=1, limit=5)
        results.append((res, out.read_text()))
    assert results[0] == results[1]
    assert len(results[1][0]) == 6  # 3 batches x 2 hybrid samples
    assert port_fh.load_studies(tmp_path / "nope.json.gz") == jax_fh.load_studies(tmp_path / "nope.json.gz") == []


def test_summarize_matches_jax(tmp_path):
    rows = [
        {"biosample": "B1", "organism_name": "human metagenome", "env_local_scale": None,
         "isolation_source": "gut", "instrument_model": "Illumina MiSeq"},
        {"biosample": "B1", "organism_name": None, "instrument_model": "MinION"},
        {"biosample": "B2", "env_local_scale": "missing", "sample_name": "soil-7"},
        {"biosample": float("nan")},
    ]
    assert port_summarize.summarize_rows(rows) == jax_summarize.summarize_rows(rows)
    inp = tmp_path / "hyb.json"
    inp.write_text(json.dumps([{"biosample": "B1"}, {"biosample": "B2"}, {"x": 1}]))
    outs = []
    for name, mod in (("jax", jax_summarize), ("port", port_summarize)):
        out = tmp_path / f"{name}.tsv"
        res = mod.summarize_hybrid(inp, out, client=FakeClient(rows, fail_times=1), batch_size=1, sleep=lambda s: None)
        outs.append((res, out.read_text()))
    assert outs[0] == outs[1]
    assert outs[1][1].count("\n") == 3


def test_manifest_helpers_match_jax(tmp_path):
    recs = test_cohort.TestManifest.RECORDS
    assert port_manifest.cohort_stats(recs) == port_manifest.CohortStats(**vars(jax_manifest.cohort_stats(recs)))
    for kw in ({}, {"platform": "OXFORD_NANOPORE", "min_bases": 100}, {"max_samples": 1}):
        assert port_manifest.select_samples(recs, **kw) == jax_manifest.select_samples(recs, **kw)
    p = tmp_path / "runs.json.gz"
    p.write_bytes(gzip.compress(json.dumps(recs).encode()))
    assert port_manifest.load_run_records(p) == jax_manifest.load_run_records(p) == recs


def _tools(transport, client=None):
    kw = {"transport": transport, "metadata_client": client, "sleep": lambda s: None}
    return jax_entrez.EntrezQueryTool(**kw), port_entrez.EntrezQueryTool(**kw)


def test_entrez_tool_matches_jax():
    search = json.dumps({"esearchresult": {"idlist": ["1", "2"], "count": "2"}})
    summary = json.dumps({"result": {
        "1": {"runs": '<Run acc="SRR1"/>'},
        "2": {"runs": "", "expxml": 'Experiment acc="ERX2"'},
    }})
    rows = [_row("S1", "SRR1", "Illumina MiSeq"), _row("S1", "ERX2", "MinION"), _row("S2", "SRR1", "MiSeq")]
    results = []
    for tool in _tools(FakeTransport({"esearch.fcgi": search, "esummary.fcgi": summary}), FakeClient(rows)):
        results.append([
            tool.search_sra("metagenome"),
            tool.search_bioproject("gut"),
            tool.get_accessions_from_uids(["1", "2"]),
            tool.validate_accession("SRR1"),
            tool.validate_accession("BOGUS"),
            tool.fetch_sra_details(["1", "2"]),
            tool.get_run_platforms_for_sample("S1"),
            tool.find_hybrid_samples("q", max_results=5),
            tool.build_sra_search_query(environment="gut", host="Homo sapiens", pathogens=["E. coli"],
                                        keywords=["a", "b"], has_long_reads=True),
            tool._build_url("esearch.fcgi", {"term": "x y"}),
        ])
    assert results[0] == results[1]
    assert port_entrez.accession_db("PRJEB1") == jax_entrez.accession_db("PRJEB1") == "bioproject"


def _patch_both(monkeypatch, make_tool=None, make_client=None):
    for mod in (jax_cmd, port_cmd):
        if make_tool is not None:
            tool_cls = jax_entrez.EntrezQueryTool if mod is jax_cmd else port_entrez.EntrezQueryTool
            monkeypatch.setattr(mod, "make_tool", make_tool(tool_cls))
        if make_client is not None:
            monkeypatch.setattr(mod, "make_client", make_client)


def _fake_tools(rows):
    def factory(tool_cls):
        def make_tool(email, api_key):
            return tool_cls(email=email, api_key=api_key, transport=FakeEutils(),
                            metadata_client=FakeMeta(rows), sleep=lambda s: None)
        return make_tool
    return factory


def _both(capsys, tmp_path, argv_of):
    """rc, stdout and the output files of both CLIs."""
    outs = []
    for name, main in (("jax", jax_main), ("port", port_cpu)):
        d = tmp_path / name
        d.mkdir()
        rc = main([str(a) for a in argv_of(d)])
        files = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
        outs.append((rc, capsys.readouterr().out, files))
    assert outs[0] == outs[1]
    return outs[1]


CLI_ROWS = [
    {"run_accession": "SRR00000", "sample_accession": "SAMN1", "instrument_model": "Illumina MiSeq"},
    {"run_accession": "SRR00001", "sample_accession": "SAMN1", "instrument_model": "MinION"},
]


@pytest.mark.parametrize(
    "args",
    [
        ["search", "--sra", "-k", "Klebsiella", "-e", "blood", "-H", "Homo sapiens"],
        ["search", "--hybrid-only", "-k", "metagenome", "-m", "5"],
        ["search", "--from-bioproject", "PRJNA12345"],
        ["search", "--from-pubmed", "123"],
        ["search", "--bioproject", "-k", "gut", "-p", "E. coli"],
        ["search", "--pubmed", "-k", "gut", "--get-sra"],
        ["search", "--no-short-reads", "-p", "Salmonella"],
    ],
    ids=["sra", "hybrid-only", "from-bioproject", "from-pubmed", "bioproject", "pubmed", "no-short"],
)
def test_cohort_search_cli_matches_jax(tmp_path, monkeypatch, capsys, args):
    _patch_both(monkeypatch, make_tool=_fake_tools(CLI_ROWS))
    rc, out, files = _both(capsys, tmp_path, lambda d: ["cohort", *args, "-o", d / "res.json"])
    assert rc == 0


def test_cohort_search_config_and_errors_match_jax(tmp_path, monkeypatch, capsys):
    _patch_both(monkeypatch, make_tool=_fake_tools(CLI_ROWS))
    cfg = tmp_path / "c.yaml"
    cfg.write_text("environment: blood\nhost: Homo sapiens\nkeywords: [x]\n")
    rc, out, files = _both(capsys, tmp_path, lambda d: ["cohort", "search", "-c", cfg, "-o", d / "res.json"])
    assert rc == 0 and json.loads(files["res.json"])
    for sub, argv in (("bp", ["cohort", "search", "--bioproject"]), ("pm", ["cohort", "search", "--pubmed"]),
                      ("cfg", ["cohort", "search", "-c", tmp_path / "none.yaml"])):
        (tmp_path / sub).mkdir()
        rc, _, _ = _both(capsys, tmp_path / sub, lambda d: argv)
        assert rc == 1


def test_cohort_validate_cli_matches_jax(tmp_path, monkeypatch, capsys):
    _patch_both(monkeypatch, make_tool=_fake_tools(CLI_ROWS))
    rc, out, _ = _both(capsys, tmp_path, lambda d: ["cohort", "validate", "SRR12345678", "SAMN99999999", "XYZ1"])
    assert rc == 0 and "SRR12345678: VALID" in out and "SAMN99999999: INVALID" in out
    (tmp_path / "strict").mkdir()
    rc, _, _ = _both(capsys, tmp_path / "strict", lambda d: ["cohort", "validate", "--strict", "SAMN99999999"])
    assert rc == 1


def test_cohort_hybrid_and_summarize_cli_match_jax(tmp_path, monkeypatch, capsys):
    rows = [
        {"study_accession": "PRJ1", "sample_accession": "S1", "run_accession": "R1",
         "instrument_model": "Illumina MiSeq", "biosample": "S1", "organism_name": "gut metagenome"},
        {"study_accession": "PRJ1", "sample_accession": "S1", "run_accession": "R2",
         "instrument_model": "MinION", "biosample": "S1", "isolation_source": "stool"},
    ]

    class Client:
        def sra_metadata(self, accessions, detailed=True):
            return rows

    _patch_both(monkeypatch, make_client=lambda: Client())
    manifest = tmp_path / "runs.json.gz"
    manifest.write_bytes(gzip.compress(json.dumps(rows).encode()))
    rc, _, files = _both(capsys, tmp_path, lambda d: ["cohort", "hybrid", "-i", manifest, "-o", d / "hybrid.json",
                                                      "--workers", 1])
    assert rc == 0 and [h["biosample"] for h in json.loads(files["hybrid.json"])] == ["S1"]
    hybrid = tmp_path / "port" / "hybrid.json"
    (tmp_path / "sum").mkdir()
    rc, _, files = _both(capsys, tmp_path / "sum", lambda d: ["cohort", "summarize", "-i", hybrid, "-o", d / "s.tsv"])
    assert rc == 0 and files["s.tsv"].decode().splitlines()[1] == "S1\tgut metagenome\tstool\tIllumina MiSeq, MinION"
