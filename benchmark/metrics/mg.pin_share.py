# mg.pin_share.py — percent of the traced stretch the main thread spent pinning host
# memory (host.pin spans), mg cells
from benchlib import spans


def read(ctx):
    return spans.self_share(ctx, "mg", "host.pin")
