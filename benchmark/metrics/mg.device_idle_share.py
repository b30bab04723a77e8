# mg.device_idle_share.py — percent of the traced stretch the card was idle, mg cells
from benchlib import readers


def read(ctx):
    return readers.idle_share(ctx, "mg")
