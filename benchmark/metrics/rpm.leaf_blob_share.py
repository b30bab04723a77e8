# rpm.leaf_blob_share.py — percent of the traced stretch's RPM batches whose blob the leaf's
# own CUDA graph wrote (the rpm.batch spans' blob attribute "leaf"; "step": a blob graph of its own)
from benchlib import spans


def read(ctx):
    v = spans.view(ctx, "rpm")
    if v is None:
        return None
    blobs = [s.attrs["blob"] for s in v.spans
             if s.name == "rpm.batch" and "blob" in s.attrs]
    if not blobs:
        return None
    return 100.0 * blobs.count("leaf") / len(blobs)
