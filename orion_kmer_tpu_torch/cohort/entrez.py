"""NCBI Entrez eutils query client (reference entrez-tool equivalent).

Lean re-implementation of the reference EntrezQueryTool
(entrez-tool/entrez_query.py:30-433): eutils esearch/esummary/elink over
HTTP with per-key rate limiting (0.34s without API key, 0.1s with,
ref:37), SRA UID -> run/experiment accession conversion via regex over
esummary `runs`/`expxml` strings (ref:270-306), accession validation by
prefix-mapped database probe (ref:394-433), the SRA search query
builder, and the hybrid-only paginated filtering loop (ref:765-825).

The HTTP transport is injectable (``transport(url) -> str | None``) so
everything is testable offline; metadata detail fetches go through the
cohort.client interface rather than hard-depending on pysradb.
"""

from __future__ import annotations

import json
import logging
import re
import time
from typing import Callable, Optional
from urllib.parse import quote

from .client import MetadataClient

logger = logging.getLogger("orion_kmer_tpu_torch.cohort.entrez")

ACCESSION_DB_MAP = {
    # prefix -> entrez db (entrez_query.py:397-402)
    "SRR": "sra", "ERR": "sra", "DRR": "sra",
    "SRX": "sra", "ERX": "sra", "DRX": "sra",
    "SAMN": "biosample", "SAME": "biosample", "SAMD": "biosample",
    "PRJNA": "bioproject", "PRJEB": "bioproject", "PRJDB": "bioproject",
}


def accession_db(accession: str) -> str | None:
    """Map an accession to its Entrez database by prefix (ref:394-410)."""
    for plen in (5, 4, 3):
        db = ACCESSION_DB_MAP.get(accession[:plen])
        if db:
            return db
    return None


def _default_transport(url: str) -> str | None:
    from urllib.error import HTTPError, URLError
    from urllib.request import urlopen

    try:
        with urlopen(url, timeout=30) as response:
            return response.read().decode("utf-8")
    except HTTPError as e:
        logger.error("HTTP Error %s: %s", e.code, e.reason)
        return None
    except URLError as e:
        logger.error("URL Error: %s", e.reason)
        return None


class EntrezQueryTool:
    BASE_URL = "https://eutils.ncbi.nlm.nih.gov/entrez/eutils/"

    def __init__(
        self,
        email: str = "user@example.com",
        api_key: Optional[str] = None,
        transport: Callable[[str], Optional[str]] | None = None,
        metadata_client: MetadataClient | None = None,
        sleep=time.sleep,
    ):
        self.email = email
        self.api_key = api_key
        self.delay = 0.34 if not api_key else 0.1  # NCBI rate limits (ref:38)
        self._transport = transport or _default_transport
        self._metadata_client = metadata_client
        self._sleep = sleep

    # --- plumbing -------------------------------------------------------

    def _build_url(self, endpoint: str, params: dict) -> str:
        params = dict(params)
        params["email"] = self.email
        if self.api_key:
            params["api_key"] = self.api_key
        param_str = "&".join(f"{k}={quote(str(v))}" for k, v in params.items())
        return f"{self.BASE_URL}{endpoint}?{param_str}"

    def _make_request(self, url: str) -> str | None:
        self._sleep(self.delay)
        return self._transport(url)

    def _get_json(self, endpoint: str, params: dict) -> dict | None:
        response = self._make_request(self._build_url(endpoint, params))
        if not response:
            return None
        try:
            return json.loads(response)
        except json.JSONDecodeError:
            logger.error("Error parsing %s response", endpoint)
            return None

    # --- searches -------------------------------------------------------

    def search_sra(self, query: str, retmax: int = 100, retstart: int = 0):
        """esearch over SRA -> (uid list, total count) (ref:246-268)."""
        data = self._get_json(
            "esearch.fcgi",
            {"db": "sra", "term": query, "retmax": str(retmax),
             "retstart": str(retstart), "retmode": "json"},
        )
        if data is None:
            return [], 0
        res = data.get("esearchresult", {})
        return res.get("idlist", []), int(res.get("count", "0"))

    def search_bioproject(self, query: str, retmax: int = 50) -> list[str]:
        """esearch over BioProject -> uid list (ref:113-132)."""
        data = self._get_json(
            "esearch.fcgi",
            {"db": "bioproject", "term": query, "retmax": str(retmax),
             "retmode": "json"},
        )
        if data is None:
            return []
        return data.get("esearchresult", {}).get("idlist", [])

    def get_sra_from_bioproject(self, bioproject_acc: str) -> list[str]:
        """SRA uids linked to a BioProject (ref:178-194)."""
        uids, _ = self.search_sra(f"{bioproject_acc}[BioProject]", retmax=500)
        return uids

    def get_sra_from_pubmed(self, pmid: str) -> list[str]:
        """elink pubmed -> sra uid list (ref:89-111)."""
        data = self._get_json(
            "elink.fcgi",
            {"dbfrom": "pubmed", "db": "sra", "id": pmid, "retmode": "json"},
        )
        if data is None:
            return []
        sra_ids = []
        for linkset in data.get("linksets", []):
            for linksetdb in linkset.get("linksetdbs", []):
                if linksetdb.get("dbto") == "sra":
                    sra_ids.extend(linksetdb.get("links", []))
        return sra_ids

    def search_pubmed(self, query: str, retmax: int = 20) -> list[dict]:
        """esearch + esummary over PubMed -> article dicts.

        The reference uses metapub (entrez_query.py:330-360); this is a
        pure-eutils redesign with the same output fields (pmid, title,
        authors, journal, year) so the CLI surface matches without the
        metapub dependency."""
        data = self._get_json(
            "esearch.fcgi",
            {"db": "pubmed", "term": query, "retmax": str(retmax),
             "retmode": "json"},
        )
        if data is None:
            return []
        uids = data.get("esearchresult", {}).get("idlist", [])
        if not uids:
            return []
        summ = self._get_json(
            "esummary.fcgi",
            {"db": "pubmed", "id": ",".join(uids), "retmode": "json"},
        )
        articles: list[dict] = []
        result = (summ or {}).get("result", {})
        for uid in uids:
            item = result.get(uid)
            if not item:
                articles.append({"pmid": uid})
                continue
            articles.append(
                {
                    "pmid": uid,
                    "title": item.get("title"),
                    "authors": [a.get("name") for a in item.get("authors", [])],
                    "journal": item.get("fulljournalname"),
                    "year": (item.get("pubdate") or "").split(" ")[0],
                }
            )
        return articles

    # --- uid -> accession conversion (ref:270-306) -----------------------

    def get_accessions_from_uids(self, uids: list[str]) -> list[str]:
        if not uids:
            return []
        data = self._get_json(
            "esummary.fcgi",
            {"db": "sra", "id": ",".join(uids), "retmode": "json"},
        )
        if data is None:
            return []
        accessions: list[str] = []
        result = data.get("result", {})
        for uid in uids:
            item = result.get(uid)
            if not item:
                continue
            runs_str = item.get("runs", "")
            matches = re.findall(r'acc="([SED]RR\d+)"', runs_str)
            if matches:
                accessions.extend(matches)
            else:
                match_exp = re.search(
                    r'Experiment\s+acc="([SED]RX\d+)"', item.get("expxml", ""),
                    re.IGNORECASE,
                )
                if match_exp:
                    accessions.append(match_exp.group(1))
        return sorted(set(accessions))

    # --- validation (ref:394-433) ----------------------------------------

    def validate_accession(self, accession: str) -> tuple[bool, str]:
        db = accession_db(accession)
        if not db:
            return False, "Unknown accession format"
        data = self._get_json(
            "esearch.fcgi",
            {"db": db, "term": f"{accession}[Accession]", "retmode": "json"},
        )
        if data is None:
            return False, "API request failed"
        count = int(data.get("esearchresult", {}).get("count", "0"))
        if count > 0:
            return True, f"Valid {db.upper()} accession"
        return False, f"Accession not found in {db.upper()}"

    # --- query building (ref:390-... build_sra_search_query) --------------

    @staticmethod
    def build_sra_search_query(
        environment: str | None = None,
        pathogens: list[str] | None = None,
        host: str | None = None,
        keywords: list[str] | None = None,
        has_short_reads: bool = True,
        has_long_reads: bool = False,
    ) -> str:
        terms = []
        if environment:
            terms.append(f'"{environment}"')
        if host:
            terms.append(f'"{host}"[Organism]')
        if pathogens:
            terms.append("(" + " OR ".join(f'"{p}"' for p in pathogens) + ")")
        if keywords:
            terms.append("(" + " OR ".join(f'"{k}"' for k in keywords) + ")")
        platform_terms = []
        if has_short_reads:
            platform_terms.append('"illumina"[Platform]')
        if has_long_reads:
            platform_terms.append('("oxford nanopore"[Platform] OR "pacbio smrt"[Platform])')
        if platform_terms:
            terms.append("(" + " AND ".join(platform_terms) + ")")
        return " AND ".join(terms) if terms else "metagenome"

    # --- sample platform probing + hybrid loop (ref:384-392, 765-825) -----

    def get_run_platforms_for_sample(self, sample_acc: str) -> list[str]:
        if self._metadata_client is None:
            logger.error("No metadata client configured")
            return []
        try:
            rows = self._metadata_client.sra_metadata([sample_acc], detailed=False)
        except Exception as e:  # noqa: BLE001
            logger.error("Error fetching platforms for sample %s: %s", sample_acc, e)
            return []
        platforms = set()
        for row in rows:
            instr = row.get("instrument_model")
            if instr is None or instr != instr:
                continue
            up = str(instr).upper()
            if "ILLUMINA" in up:
                platforms.add("ILLUMINA")
            elif "BGI" in up:
                platforms.add("BGISEQ")
            elif "NANOPORE" in up or "MINION" in up or "PROMETHION" in up:
                platforms.add("OXFORD_NANOPORE")
            elif "PACBIO" in up or "SEQUEL" in up:
                platforms.add("PACBIO_SMRT")
            else:
                platforms.add(up)
        return sorted(platforms)

    def fetch_sra_details(self, uids: list[str]) -> list[dict]:
        """uids -> accessions -> metadata rows (ref:308-328)."""
        accessions = self.get_accessions_from_uids(uids)
        if not accessions or self._metadata_client is None:
            return []
        try:
            rows = self._metadata_client.sra_metadata(accessions, detailed=True)
        except Exception as e:  # noqa: BLE001
            logger.error("pysradb metadata fetch failed: %s", e)
            return []
        return rows

    def find_hybrid_samples(
        self,
        query: str,
        max_results: int = 10,
        batch_size: int = 50,
        max_search_limit: int = 1000,
    ) -> list[dict]:
        """Paginated hybrid-only filtering loop (ref:765-825)."""
        processed: set[str] = set()
        valid: set[str] = set()
        final_details: list[dict] = []
        start = 0
        while len(valid) < max_results and start < max_search_limit:
            uids, total = self.search_sra(query, retmax=batch_size, retstart=start)
            if not uids:
                break
            for record in self.fetch_sra_details(uids):
                if len(valid) >= max_results:
                    break
                sample_acc = record.get("sample_accession")
                if not sample_acc or sample_acc == "N/A":
                    continue
                if sample_acc in processed:
                    if sample_acc in valid:
                        final_details.append(record)
                    continue
                processed.add(sample_acc)
                platforms = self.get_run_platforms_for_sample(sample_acc)
                has_short = any(p in ("ILLUMINA", "BGISEQ") for p in platforms)
                has_long = any(
                    p in ("OXFORD_NANOPORE", "PACBIO_SMRT") for p in platforms
                )
                if has_short and has_long:
                    valid.add(sample_acc)
                    final_details.append(record)
            start += batch_size
            if start >= total:
                break
        logger.info(
            "Found %d hybrid samples after checking %d candidates.",
            len(valid),
            len(processed),
        )
        return final_details


def load_config(config_path: str) -> dict:
    """YAML config loader (ref:437-447)."""
    import yaml

    with open(config_path) as f:
        return yaml.safe_load(f)
