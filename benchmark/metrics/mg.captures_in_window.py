# mg.captures_in_window.py — CUDA graphs captured inside the window, mg cells
from benchlib import readers


def read(ctx):
    return readers.captures(ctx, "mg")
