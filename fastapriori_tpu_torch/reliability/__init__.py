"""The single-process reliability core (counterpart: the JAX package's
``reliability`` package without its quorum): deterministic fault
injection (failpoints.py), the degradation ledger (ledger.py), bounded
retries of audited fetches (retry.py), and the dispatch watchdog with
the degradation cascade (watchdog.py)."""
