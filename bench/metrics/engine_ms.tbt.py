"""Mean wall ms of ``TorchEngine.execute`` over the window's steps
before the profiler started (``nbench.readers.engine_ms``), in the
decode-heavy cells, read beside ``tbt_p95_ms.host``."""
from nbench.readers import engine_ms as read  # noqa: F401
