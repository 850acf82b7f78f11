"""Share of the model's operations in the toy's FC box head, in %: a reader
of a work count that only the toy's architecture module names."""


def read(ctx):
    if "fc_flops" not in ctx.work or not ctx.work["model_flops"]:
        return None
    return ctx.work["fc_flops"] / ctx.work["model_flops"] * 100.0
