"""Transaction/user-basket file ingestion (counterpart:
fastapriori_tpu/io/reader.py; reference Utils.scala:19-27).

The reference reads ``<input>D.dat`` and ``<input>U.dat`` as whitespace-
tokenized lines (``trim().split("\\s+")`` — an empty line yields a single
empty token, Java split semantics).  A path with a scheme (``gs://``,
``hdfs://``, ``memory://``) goes through fsspec, imported only for such
a path; without fsspec it is an InputError naming the path.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from fastapriori_tpu_torch.errors import InputError

# Java semantics, NOT Python's: String.trim() removes chars <= 0x20 (so
# control bytes like \x01 are trimmed, but \xa0 — which Python's
# str.strip() would eat — is kept), and regex \s is ASCII-only.
JAVA_WS = frozenset(" \t\n\x0b\f\r")  # regex \s under Java semantics
_WS = re.compile("[" + "".join(sorted(JAVA_WS)) + "]+")
_TRIM = "".join(chr(i) for i in range(0x21))


def tokenize_line(line: str) -> List[str]:
    """Java-compatible ``line.trim().split("\\s+")`` (Utils.scala:21)."""
    return _WS.split(line.strip(_TRIM))


def _require_fsspec(path: str):
    """The fsspec module, or an InputError naming the remote path."""
    try:
        import fsspec
    except ImportError as e:
        raise InputError(
            f"remote path {path!r} requires fsspec, which is not "
            "installed; copy the file locally instead"
        ) from e
    return fsspec


def _open(path: str):
    """``open(path, "r")``, through fsspec for a remote path."""
    if "://" in path:
        return _require_fsspec(path).open(path, "r").open()
    return open(path, "r")


def _open_bytes(path: str):
    """Binary twin of :func:`_open` (manifest validation hashes raw
    bytes)."""
    if "://" in path:
        return _require_fsspec(path).open(path, "rb").open()
    return open(path, "rb")


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
    with _open(path) as f:
        return [tokenize_line(line) for line in split_lines_java(f.read())]


def read_input_dir(
    input_prefix: str,
) -> Tuple[List[List[str]], List[List[str]]]:
    """Read ``<prefix>D.dat`` and ``<prefix>U.dat`` (Utils.scala:21-23: the
    prefix is concatenated without a separator, so a trailing ``/`` is
    the caller's)."""
    return read_dat(input_prefix + "D.dat"), read_dat(input_prefix + "U.dat")
