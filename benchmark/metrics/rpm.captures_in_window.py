# rpm.captures_in_window.py — CUDA graphs captured inside the window, RPM cells
from benchlib import readers


def read(ctx):
    return readers.captures(ctx, "rpm")
