"""Scenario batching on one card (see batch.py)."""

from .batch import batched_dc_solve, batched_nr_solve, batched_se_solve

__all__ = ["batched_dc_solve", "batched_nr_solve", "batched_se_solve"]
