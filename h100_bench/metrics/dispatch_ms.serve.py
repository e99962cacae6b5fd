"""``dispatch_ms.serve`` (ms): the host's time to enqueue one register call
(the call returns before the device has run it), summed over the calls of
the untraced window that a traced run makes before its traced one (the
profiler's events would add to it) and divided by their number."""


def read(run):
    if run.trace is None or not run.dispatch_s:
        return None
    return 1e3 * sum(run.dispatch_s) / len(run.dispatch_s)
