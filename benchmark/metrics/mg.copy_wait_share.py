# mg.copy_wait_share.py — percent of the traced stretch the main thread waited for a blob's
# copy to the host (transfer.wait spans), mg cells
from benchlib import spans


def read(ctx):
    return spans.self_share(ctx, "mg", "transfer.wait")
