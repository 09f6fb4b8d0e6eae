"""color_step_us: the profiled device time of ``color_sweep_kernel`` over
the dependent colour steps the port launched in the traced calls (the
``steps`` count, n_sweeps x n_colours per launch, on its
``repro_torch.kernel.color_sweep`` span; ``_spans.py``), in us per step.
None unless the profiled launches are exactly the traced calls' spans
that launched (``steps`` > 0): a launch outside a span, or a span whose
launch the trace lacks, would divide one stretch's time by another's
steps."""

from portbench import trace
from portbench.metrics._spans import traced_requests


def read(ctx):
    if ctx.trace is None or ctx.work["kind"] != "train":
        return None
    reqs = traced_requests(ctx, "train.sweep")
    if not reqs:
        return None
    dev_s, launches = trace.kernel_seconds(ctx.trace, "color_sweep_kernel")
    steps = [r.counts.get("steps", 0) for _, recs in reqs for r in recs
             if r.name == "kernel.color_sweep"]
    steps = [s for s in steps if s > 0]
    if launches != len(steps) or launches == 0 or dev_s <= 0:
        return None
    return 1e6 * dev_s / sum(steps)
