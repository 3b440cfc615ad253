"""The whole step's share of the card's peak over the window
(``nbench.readers.mfu_pct``), read beside the metrics that move
tbt_p95_ms."""
from nbench.readers import mfu_pct as read  # noqa: F401
