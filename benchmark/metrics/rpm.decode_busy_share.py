# rpm.decode_busy_share.py — percent of the export threads' time in the traced stretch spent
# decoding a sample's delta-coded frames and writing their PNGs (export.task spans of fn
# delta_sample), RPM cells
from benchlib import export_spans


def read(ctx):
    return export_spans.task_busy_share(ctx, "rpm", ("delta_sample",))
