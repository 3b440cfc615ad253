"""Prompt tokens prefilled plus output tokens generated inside the
window, a second of the window: a step's chunks count when the step
returns inside it, an output token when it is produced inside it."""


def read(run):
    prompt = sum(real for s in run.window_steps() for _, real in s.chunks)
    out = sum(run.t_open <= t < run.t_close for r in run.reqs
              for t in r.tokens)
    return (prompt + out) / run.seconds
