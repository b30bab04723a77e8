# rpm.pool_busy_share.py — percent of the export threads' time in the traced stretch spent
# in export tasks, RPM cells
from benchlib import spans


def read(ctx):
    return spans.pool_busy_share(ctx, "rpm")
