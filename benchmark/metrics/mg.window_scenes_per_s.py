# mg.window_scenes_per_s.py — mg scenes a second over the window's calls
from benchlib import readers


def read(ctx):
    return readers.window_rate(ctx, "mg")
