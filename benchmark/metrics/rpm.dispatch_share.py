# rpm.dispatch_share.py — percent of the traced stretch the main thread spent dispatching RPM
# batches (its own time in rpm.dispatch spans, pinning left out)
from benchlib import spans


def read(ctx):
    return spans.self_share(ctx, "rpm", "rpm.dispatch")
