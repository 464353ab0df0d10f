"""Native (C++) fast paths for host-side preprocessing (counterpart: the
JAX package's ``native`` module).

``csrc/preprocess.cc`` (tokenize + count + rank + dedup in one pass over
the raw bytes, the block-replay ingest, the candidate join + prune and
the output artifacts' layout for io/writer.py) is
built at first use by ops/build.py with the host compiler into
``_build/`` and loaded through ctypes (native/loader.py).  The engine
choice lives in preprocess.py ``_use_native``; this module only answers
availability, and why not.
"""

from __future__ import annotations

from typing import Optional


def native_available() -> bool:
    """True when the native library is built (or builds now) and loads."""
    from fastapriori_tpu_torch.native.loader import get_lib

    return get_lib() is not None


def unavailable_reason() -> Optional[str]:
    """Why :func:`native_available` is false (the compiler's first error
    line, or the load error); None when the library is available."""
    from fastapriori_tpu_torch.native.loader import get_lib, load_error

    return None if get_lib() is not None else load_error()
