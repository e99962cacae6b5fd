"""``synthesis_ms.train`` (ms): device time a step of the kernels launched
inside SynthMorph's synthesis (its draws and ``labels_to_image_from_draws``),
on this rank."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    s = run.trace.kernel_seconds(lambda k: "synthesis" in k.spans)
    return 1e3 * s / run.steps if s > 0 else None
