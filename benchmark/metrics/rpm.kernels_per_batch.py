# rpm.kernels_per_batch.py — device kernels per RPM leaf batch in the traced stretch
from benchlib import readers


def read(ctx):
    return readers.kernels_per_batch(ctx, "rpm")
