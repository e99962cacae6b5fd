"""``nccl_ms.dp`` (ms): device time a step of NCCL's kernels (the
gradient all-reduce, the metrics' mean, the window's broadcast), on this
rank; a kernel's time includes its wait for the other ranks."""


def read(run):
    if run.trace is None or not run.steps or run.world < 2:
        return None
    s = run.trace.kernel_seconds(lambda k: "nccl" in k.name.lower())
    return 1e3 * s / run.steps if s > 0 else None
