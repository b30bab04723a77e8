# graphs.warmup_s.py — seconds of set-up's warm call, which captures every
# graph the window replays (the harness's own span round it)


def read(ctx):
    return ctx.get("warmup_s")
