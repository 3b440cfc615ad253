"""The paged decode kernel's share of its roofline over the traced
steps: the least time the plans' decode rows need (``decode_work`` of
their real context lengths, each layer once, at the card's peaks) over
the device time of the kernels named ``paged_decode*``, in %."""
from nbench.yardstick import bound_ms, decode_work


def read(run):
    t = run.trace
    dev = sum(v for k, v in (t.kernels if t else {}).items()
              if "paged_decode" in k)
    if not dev:
        return None
    m, dt = run.model, run.dtype
    es = dt.itemsize
    bound = 0.0
    for s in run.traced_steps():
        if s.ctxs:
            nb, fl = decode_work(s.ctxs, m["num_heads"], m["num_kv_heads"],
                                 m["head_dim"],
                                 run.serve["block_size"], es)
            bound += m["num_layers"] * bound_ms(nb, fl, dt)[0]
    return 100.0 * bound * 1e-3 / dev
