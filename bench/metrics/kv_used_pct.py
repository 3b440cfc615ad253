"""Mean share of the KV pool's blocks held after each of the window's
steps that ran before the profiler started (``Run.host_steps``), in %."""


def read(run):
    s = run.host_steps()
    return 100.0 * sum(x.kv_used / x.kv_total for x in s) / len(s) \
        if s else None
