"""Device ms a traced step spends inside the MoE FFN's spans
(``moe.router``, ``moe.experts``, ``moe.combine`` in
``repro_torch/models/moe.py``)."""


def read(run):
    t = run.trace
    if t is None or not t.steps:
        return None
    ms = sum(v for k, v in t.spans.items() if k.startswith("moe.")) * 1e3
    return ms / t.steps if ms else None
