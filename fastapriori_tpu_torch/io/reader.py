"""Transaction/user-basket file ingestion (counterpart:
fastapriori_tpu/io/reader.py; reference Utils.scala:19-27).

The reference reads ``<input>D.dat`` and ``<input>U.dat`` as whitespace-
tokenized lines (``trim().split("\\s+")`` — an empty line yields a single
empty token, Java split semantics).  Local files only in this port.
"""

from __future__ import annotations

import re
from typing import List

# Java semantics, NOT Python's: String.trim() removes chars <= 0x20 (so
# control bytes like \x01 are trimmed, but \xa0 — which Python's
# str.strip() would eat — is kept), and regex \s is ASCII-only.
JAVA_WS = frozenset(" \t\n\x0b\f\r")  # regex \s under Java semantics
_WS = re.compile("[" + "".join(sorted(JAVA_WS)) + "]+")
_TRIM = "".join(chr(i) for i in range(0x21))


def tokenize_line(line: str) -> List[str]:
    """Java-compatible ``line.trim().split("\\s+")`` (Utils.scala:21)."""
    return _WS.split(line.strip(_TRIM))


def split_lines_java(content: str) -> List[str]:
    """Split on ``\\n`` ONLY, dropping the empty tail a trailing newline
    leaves — the record-splitting rule of Spark textFile (Python's
    ``str.splitlines()`` would also split on \\x0b, \\x0c, \\x1c-\\x1e,
    \\x85 and unicode line separators)."""
    if not content:
        return []
    lines = content.split("\n")
    if lines[-1] == "":
        lines.pop()
    return lines


def read_dat(path: str) -> List[List[str]]:
    """Read one ``*.dat`` file into a list of token lists, one per line."""
    with open(path, "r") as f:
        return [tokenize_line(line) for line in split_lines_java(f.read())]
