# rpm.export_share.py — percent of the traced stretch the main thread spent exporting RPM
# batches (rpm.export spans, less the copy wait)
from benchlib import spans


def read(ctx):
    return spans.self_share(ctx, "rpm", "rpm.export")
