# k1_roofline.py — K1's share of its bytes' roofline over the traced stretch
from benchlib import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "rpm")
