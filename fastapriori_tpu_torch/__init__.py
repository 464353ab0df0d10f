"""fastapriori_tpu_torch — the PyTorch/CUDA port of fastapriori_tpu.

Apriori frequent-itemset mining plus association-rule recommendation on
one NVIDIA GPU.  The layout mirrors the JAX package (``io/``, ``ops/``,
``models/``, ``rules/``, ``utils/``, ``cli.py``); each module names its
counterpart.  The JAX package's Pallas TPU kernels on this path are
CUDA C++ kernels written for Hopper (``csrc/``), built with ``nvcc`` at
first use into ``_build/``.

This package never imports ``jax`` or ``fastapriori_tpu``.
"""

from fastapriori_tpu_torch.errors import InputError
from fastapriori_tpu_torch.models.apriori import FastApriori
from fastapriori_tpu_torch.models.recommender import AssociationRules

__all__ = ["AssociationRules", "FastApriori", "InputError"]
