"""Scenario batching on one card (see batch.py)."""

from .batch import batched_nr_solve, batched_se_solve

__all__ = ["batched_nr_solve", "batched_se_solve"]
