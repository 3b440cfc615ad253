"""Mean host ms a step spends inside ``NiyamaScheduler.schedule``, over
the window's steps that ran before the profiler started
(``Run.host_steps``; timed by the harness's proxy around the call)."""


def read(run):
    s = run.host_steps()
    return 1e3 * sum(x.sched_s for x in s) / len(s) if s else None
