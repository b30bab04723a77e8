# mg.idle_unattributed_share.py — percent of the card's idle time in the traced stretch that no
# stage span of the main thread covers, mg cells
from benchlib import spans


def read(ctx):
    return spans.idle_unattributed_share(ctx, "mg")
