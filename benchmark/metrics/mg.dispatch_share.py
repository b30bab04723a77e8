# mg.dispatch_share.py — percent of the traced stretch the main thread spent dispatching mg
# batches: render replay, pack, coalesce, copy start (mg.dispatch, pinning left out)
from benchlib import spans


def read(ctx):
    return spans.self_share(ctx, "mg", "mg.dispatch")
