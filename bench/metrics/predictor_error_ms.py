"""Mean, over the window's steps that ran before the profiler started
(``Run.host_steps``), of the engine's measured seconds for
the step (``TorchEngine.iteration_log``) less the scheduler's predicted
seconds for its plan (``plan.predicted_time``), in ms."""


def read(run):
    d = [s.engine_s - s.predicted_s for s in run.host_steps()
         if s.engine_s is not None and s.predicted_s is not None]
    return 1e3 * sum(d) / len(d) if d else None
