"""Error taxonomy.

Mirrors the reference error enum (orion-kmer/src/errors.rs:5-40) -- the
message strings are load-bearing: integration tests assert on stderr
substrings, so the exact templates are reproduced here.
"""

from __future__ import annotations


class OrionKmerError(Exception):
    """Base class for all orion-kmer-tpu errors (errors.rs:5)."""


class InvalidKmerSize(OrionKmerError):
    # errors.rs:6-7
    def __init__(self, k: int):
        self.k = k
        super().__init__(f"Invalid K-mer size: {k}. Must be between 1 and 32.")


class FileNotFound(OrionKmerError):
    # errors.rs:9-10
    def __init__(self, path: str):
        super().__init__(f"File not found: {path}")


class FileParsingError(OrionKmerError):
    # errors.rs:12-13
    def __init__(self, detail: str):
        super().__init__(f"Failed to parse input file: {detail}")


class SerializationError(OrionKmerError):
    # errors.rs:18-19
    def __init__(self, detail: str):
        super().__init__(f"Serialization error: {detail}")


class DeserializationError(OrionKmerError):
    # errors.rs:21-22
    def __init__(self, detail: str):
        super().__init__(f"Deserialization error: {detail}")


class KmerSizeMismatch(OrionKmerError):
    # errors.rs:24-25 (compare)
    def __init__(self, k1: int, k2: int):
        super().__init__(
            f"K-mer databases have incompatible k-mer sizes (overall comparison): {k1} vs {k2}"
        )


class KmerSizeMismatchValidation(OrionKmerError):
    # errors.rs:27-28 (classify: user k vs db k)
    def __init__(self, user_k: int, db_k: int, path: str):
        super().__init__(
            f"User-provided k-mer size {user_k} does not match k-mer size {db_k} "
            f'from database: "{path}"'
        )


class KmerSizeMismatchBetweenDatabases(OrionKmerError):
    # errors.rs:30-33 (classify: db k vs first-db k)
    def __init__(self, first_k: int, db_k: int, path: str):
        super().__init__(
            f"Effective k-mer size {first_k} (from first database) does not match "
            f'k-mer size {db_k} from database: "{path}"'
        )


class GenericError(OrionKmerError):
    # errors.rs:35-36
    def __init__(self, detail: str):
        super().__init__(f"Generic error: {detail}")


class ContextError(OrionKmerError):
    """An error with an anyhow-style context chain.

    The reference wraps lower-level errors with ``.with_context(...)``
    (e.g. count.rs:60) and main prints the outermost context message
    (main.rs:11).  We keep the chain so the CLI can print
    "outer: inner: ..." -- a superset of the reference's stderr.
    """

    def __init__(self, context: str, cause: Exception | None = None):
        self.context = context
        self.cause = cause
        msg = context
        if cause is not None:
            msg = f"{context}: {cause}"
        super().__init__(msg)


def validate_k(k: int) -> None:
    """k must be in 1..=32 (count.rs:43-45, build.rs:83-85)."""
    if k is None or k < 1 or k > 32:
        raise InvalidKmerSize(k)
