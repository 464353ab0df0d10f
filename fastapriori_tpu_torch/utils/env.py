"""Strict environment parsing (counterpart: fastapriori_tpu/utils/env.py
``env_choice``).

The port reads one environment variable, ``FA_MINE_ENGINE``
(models/apriori.py); a value it does not know is an error, never a quiet
default.
"""

from __future__ import annotations

import os
from typing import Optional

from fastapriori_tpu_torch.errors import InputError


def env_choice(
    name: str, choices: tuple, default: Optional[str] = None
) -> Optional[str]:
    """Strict enumerated knob: unset -> ``default``, a listed choice ->
    itself (case-normalized), anything else -> ``InputError``."""
    raw = os.environ.get(name, "")
    val = raw.strip().lower()
    if not val:
        return default
    if val in choices:
        return val
    raise InputError(
        f"unrecognized {name} value {raw!r}: use one of "
        f"{'/'.join(choices)} (or unset for the config default)"
    )
