# export_spans.py — per-layer metrics of full export read from the
# program's spans: the export threads' time by task kind, and the frames
# fetched raw over their shrunk capacity.
"""Read as ``spans.py``'s readers are, over the traced stretch, and None
where they read None: another system's cell, an untraced run, a trace
that dropped records, a program that records no spans, or none of this
system's calls in the stretch.  Each also reads None where the stretch
holds none of the spans it counts: no export task of its kinds, or no
batch that carries its frames shipped (a program older than the
``rpm.batch`` frame counts and the ``transfer.overflow`` span)."""
from __future__ import annotations

from . import spans

# the frame streams of a batch, as the rpm.batch and transfer.overflow
# spans count them
STREAMS = ("grid", "state", "opt")


def task_busy_share(ctx: dict, system: str, kinds):
    """Percent of the export threads' time in the stretch spent in export
    tasks whose ``fn`` is one of `kinds`: their summed durations, clipped
    to the stretch, over (the pool's worker count times the stretch's
    wall)."""
    v = spans.view(ctx, system)
    if v is None:
        return None
    tasks = [s for s in v.spans if s.name == "export.task"]
    workers = max((s.attrs.get("workers", 0) for s in tasks), default=0)
    mine = [s for s in tasks if s.attrs.get("fn") in kinds]
    if not workers or not mine:
        return None
    busy = sum(max(0.0, min(s.end_ns, v.hi) - max(s.start_ns, v.lo))
               for s in mine)
    return 100.0 * busy / (workers * v.trace["wall_s"] * 1e9)


def overflow_frame_share(ctx: dict, system: str):
    """Percent of the frames the stretch's batches shipped that were
    fetched again raw over their shrunk capacity: the frames of the
    ``transfer.overflow`` spans over those of the ``<system>.batch``
    spans, every stream counted."""
    v = spans.view(ctx, system)
    if v is None:
        return None
    shipped = sum(s.attrs[n] for s in v.spans
                  if s.name == f"{system}.batch" and "grid" in s.attrs
                  for n in STREAMS)
    if not shipped:
        return None
    raw = sum(s.attrs.get(n, 0) for s in v.spans
              if s.name == "transfer.overflow" for n in STREAMS)
    return 100.0 * raw / shipped
