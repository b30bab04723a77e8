# rpm.overflow_frame_share.py — percent of the frames the traced stretch's RPM batches
# shipped that came again raw over their shrunk capacity (transfer.overflow spans over the
# rpm.batch spans' frames)
from benchlib import export_spans


def read(ctx):
    return export_spans.overflow_frame_share(ctx, "rpm")
