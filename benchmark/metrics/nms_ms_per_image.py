"""Host milliseconds inside the NMS loops per image (training) or frame
(detection) in the traced window: the union of the program's ``tspn.nms``
spans over the window's images or frames. None where the window holds no
such span."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    iv = spans.union(spans.intervals(ctx.trace, spans.NMS))
    if not len(iv):
        return None
    return float((iv[:, 1] - iv[:, 0]).sum()) / ctx.units * 1e3
