# rpm.transfer_mb_per_sample.py — megabytes copied to the host per RPM sample
from benchlib import readers


def read(ctx):
    return readers.transfer_mb(ctx, "rpm")
