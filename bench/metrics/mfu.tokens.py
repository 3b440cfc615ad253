"""The whole step's share of the card's peak over the window
(``nbench.readers.mfu_pct``), read beside the metrics that move
tokens_s."""
from nbench.readers import mfu_pct as read  # noqa: F401
