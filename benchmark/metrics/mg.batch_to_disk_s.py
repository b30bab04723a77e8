# mg.batch_to_disk_s.py — median seconds from an mg batch's dispatch to its last file
# written (mg.batch spans of the traced stretch)
from benchlib import spans


def read(ctx):
    return spans.batch_to_disk_s(ctx, "mg")
