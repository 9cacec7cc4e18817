from .compress import open_input, open_output, read_bytes
from .fastx import FastxParseError, parse_fastx_bytes, parse_fastx_file

__all__ = [
    "open_input",
    "open_output",
    "read_bytes",
    "parse_fastx_bytes",
    "parse_fastx_file",
    "FastxParseError",
]
