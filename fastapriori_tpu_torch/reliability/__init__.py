"""The reliability core (counterpart: the JAX package's ``reliability``
package): deterministic fault injection (failpoints.py), the degradation
ledger (ledger.py), bounded retries of audited fetches (retry.py), the
dispatch watchdog with the degradation cascade (watchdog.py), and the
multi-process fault domain (quorum.py): cascade consensus, lost peers,
fenced checkpoints and elastic continuation."""
