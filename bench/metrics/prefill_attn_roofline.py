"""The chunked-prefill attention kernel's share of its roofline over the
traced steps: the least time the plans' real chunks need
(``prefill_work``, each layer once, at the card's peaks) over the device
time of the kernels named ``chunked_prefill*``, in %."""
from nbench.yardstick import bound_ms, prefill_work


def read(run):
    t = run.trace
    dev = sum(v for k, v in (t.kernels if t else {}).items()
              if "chunked_prefill" in k)
    if not dev:
        return None
    m, dt = run.model, run.dtype
    es = dt.itemsize
    bound = 0.0
    for s in run.traced_steps():
        if s.chunks:
            nb, fl = prefill_work(s.chunks, m["num_heads"],
                                  m["num_kv_heads"], m["head_dim"], es)
            bound += m["num_layers"] * bound_ms(nb, fl, dt)[0]
    return 100.0 * bound * 1e-3 / dev
