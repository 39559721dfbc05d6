"""Auxiliary subsystems: observability counters, persistence (checkpoint
and resume of CRS parameters and tree state) and profiling hooks."""

from .metrics import counters, record, reset_counters, timed_region
from .persist import (
    load_ipa_params,
    load_kzg_params,
    load_tree,
    save_ipa_params,
    save_kzg_params,
    save_tree,
)

__all__ = [
    "counters",
    "record",
    "reset_counters",
    "timed_region",
    "save_ipa_params",
    "load_ipa_params",
    "save_kzg_params",
    "load_kzg_params",
    "save_tree",
    "load_tree",
]
