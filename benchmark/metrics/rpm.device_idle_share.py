# rpm.device_idle_share.py — percent of the traced stretch the card was idle, RPM cells
from benchlib import readers


def read(ctx):
    return readers.idle_share(ctx, "rpm")
