"""Grain-table (filmgrn1) interchange + per-frame header aggregation."""

from .aggregate import aggregate_grain_headers, merge_segment_runs, packet_bounds
from .filmgrn1 import (
    GrainTableError,
    dump_table,
    load_table,
    parse_table,
    write_table,
)

__all__ = [
    "aggregate_grain_headers",
    "merge_segment_runs",
    "packet_bounds",
    "GrainTableError",
    "dump_table",
    "load_table",
    "parse_table",
    "write_table",
]
