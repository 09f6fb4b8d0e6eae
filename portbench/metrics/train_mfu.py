"""train_mfu: the operations of the traced training calls
(``counts.sweep_work``: the forward and back substitutions and z' = K c
over every real lane, every sweep) over their wall time (host clock,
each call synchronised) at 67 TFLOP/s (float32, and float64 at its
tensor-core rate), in percent."""

from portbench import counts, peaks

ITEMSIZE = {"float32": 4, "float64": 8}


def read(ctx):
    w, calls = ctx.work, ctx.window.get("traced") or []
    if w["kind"] != "train" or not calls:
        return None
    _, flops = counts.sweep_work(w["build"], w["fields"], w["sweeps"], ITEMSIZE[w["dtype"]])
    wall = sum(z - a for _, a, z, _ in calls)
    return 100.0 * flops * len(calls) / (wall * peaks.FLOPS[w["dtype"]])
