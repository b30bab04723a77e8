# mg.pool_busy_share.py — percent of the export threads' time in the traced stretch spent
# in export tasks, mg cells
from benchlib import spans


def read(ctx):
    return spans.pool_busy_share(ctx, "mg")
