"""Share of the traced window in which no device activity ran (%)."""

from vobench.metrics._read import idle_pct as read  # noqa: F401
