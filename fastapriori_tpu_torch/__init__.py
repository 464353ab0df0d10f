"""fastapriori_tpu_torch — the PyTorch/CUDA port of fastapriori_tpu.

Apriori frequent-itemset mining plus association-rule recommendation on
one NVIDIA GPU.  The layout mirrors the JAX package (``io/``, ``ops/``,
``models/``, ``rules/``, ``utils/``, ``cli.py``); each module names its
counterpart.  The JAX package's Pallas TPU kernels on this path are
CUDA C++ kernels written for Hopper (``csrc/``), built with ``nvcc`` at
first use into ``_build/``.

This package never imports ``jax`` or ``fastapriori_tpu``.  The engine
classes load on first access, so importing a standard-library module of
the port (``obs``, ``utils.env``, ``reliability.ledger``) does not
import torch.
"""

from fastapriori_tpu_torch.errors import InputError

__all__ = ["AssociationRules", "FastApriori", "InputError"]


def __getattr__(name: str):
    if name == "FastApriori":
        from fastapriori_tpu_torch.models.apriori import FastApriori

        return FastApriori
    if name == "AssociationRules":
        from fastapriori_tpu_torch.models.recommender import AssociationRules

        return AssociationRules
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
