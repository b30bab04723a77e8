# rpm.copy_wait_share.py — percent of the traced stretch the main thread waited for a blob's
# copy to the host (transfer.wait spans), RPM cells
from benchlib import spans


def read(ctx):
    return spans.self_share(ctx, "rpm", "transfer.wait")
