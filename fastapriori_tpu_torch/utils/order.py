"""Deterministic orderings standing in for the reference's
Spark-nondeterministic collect orders (counterpart:
fastapriori_tpu/utils/order.py)."""

from __future__ import annotations

from typing import Tuple


def item_sort_key(item_count: Tuple[str, int]):
    """Sort key for frequent-item rank assignment: descending count
    (FastApriori.scala:60 ``sortBy(-_._2)``), ties broken by the numeric
    value of the item token ascending, falling back to the raw token."""
    item, count = item_count
    try:
        return (-count, 0, int(item), item)
    except ValueError:
        return (-count, 1, 0, item)


def consequent_key(item: str):
    """Consequent tie order of the rule priority sort
    (AssociationRules.scala:116-120): integer-parsed ascending, then
    non-integer tokens by string."""
    try:
        return (0, int(item), item)
    except ValueError:
        return (1, 0, item)
