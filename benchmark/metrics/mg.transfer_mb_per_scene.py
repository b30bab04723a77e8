# mg.transfer_mb_per_scene.py — megabytes copied to the host per mg scene
from benchlib import readers


def read(ctx):
    return readers.transfer_mb(ctx, "mg")
