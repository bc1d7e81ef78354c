"""WFL: the WarpFlow language core — expressions, flows, planning, sessions."""
from .exprs import (P, proto, IN, BETWEEN, vsum, vmin, vmax, vcount, vmean,
                    where, func, group, CollectedTable, AggSpec)
from .flow import Flow, fdb
from .planner import plan_flow, split_find_pred
from .session import Session
from .sketches import HyperLogLog, BloomFilter, IntervalSet

__all__ = [
    "P", "proto", "IN", "BETWEEN", "vsum", "vmin", "vmax", "vcount",
    "vmean", "where", "func", "group", "CollectedTable", "AggSpec",
    "Flow", "fdb", "plan_flow", "split_find_pred", "Session",
    "HyperLogLog", "BloomFilter", "IntervalSet",
]
