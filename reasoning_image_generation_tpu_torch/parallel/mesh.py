# mesh.py — splitting sample ids over independent host processes.
"""Scale-out over hosts is one independent process per host, each
generating a disjoint strided shard of the sample ids into one output
directory (``cli.py --num_hosts/--host_id``); the merge step dedups across
hosts from the pHash carried in every meta, so no collective is needed and
no second device.  A mesh over several devices of one host is not in the
port yet.
"""
from __future__ import annotations


def host_shard_ids(ids, process_index: int, process_count: int) -> list:
    """The ids of host `process_index` of `process_count`: every
    process_count-th id, starting at process_index.  Deterministic in the
    order of `ids`, so the hosts need no coordination.  Both arguments are
    required: nothing here knows a process's rank by itself."""
    if process_count < 1 or not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} is not in "
                         f"[0, {process_count})")
    return list(ids)[process_index::process_count]
