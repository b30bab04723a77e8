# rpm.png_busy_share.py — percent of the export threads' time in the traced stretch spent
# encoding PNGs (export.task spans of fn png, png_rle, png_rle3), RPM cells
from benchlib import export_spans


def read(ctx):
    return export_spans.task_busy_share(ctx, "rpm",
                                        ("png", "png_rle", "png_rle3"))
