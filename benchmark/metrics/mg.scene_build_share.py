# mg.scene_build_share.py — percent of the traced stretch the main thread spent building mg
# scenes on the host (mg.scene_build spans)
from benchlib import spans


def read(ctx):
    return spans.self_share(ctx, "mg", "mg.scene_build")
