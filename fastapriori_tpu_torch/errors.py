"""User-facing error type (counterpart: fastapriori_tpu/errors.py).

User-correctable problems raise :class:`InputError`, which the CLI renders
as a one-line message with exit code 2 instead of a traceback.  The port
also raises it when a run asks for the GPU on a machine that has none.
"""

from __future__ import annotations


class InputError(Exception):
    """A problem the user can fix (missing file, no CUDA device, an
    engine this port does not have yet) — the message is the full,
    actionable text."""
