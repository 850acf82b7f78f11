"""Host syncs of the NMS loops per image (training) or frame (detection) in
the traced window: the program's ``tspn.nms.sync`` spans, one for each
block of the blocked loop and one more to end each call, over the window's
images or frames. None where the window holds no ``tspn.nms`` span (a
program without spans)."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    named = spans.by_name(ctx.trace)
    if spans.NMS not in named:
        return None
    return len(named.get(spans.NMS_SYNC, ())) / ctx.units
