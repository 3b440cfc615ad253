"""Mean wall ms of ``TorchEngine.execute`` over the window's steps
before the profiler started (``nbench.readers.engine_ms``), in the cells judged on the gaps between tokens."""
from nbench.readers import engine_ms as read  # noqa: F401
