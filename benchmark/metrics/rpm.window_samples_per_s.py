# rpm.window_samples_per_s.py — RPM ids a second over the window's calls
from benchlib import readers


def read(ctx):
    return readers.window_rate(ctx, "rpm")
