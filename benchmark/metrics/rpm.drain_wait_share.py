# rpm.drain_wait_share.py — percent of the traced stretch the main thread waited for the
# export threads (export.drain spans), RPM cells
from benchlib import spans


def read(ctx):
    return spans.self_share(ctx, "rpm", "export.drain")
