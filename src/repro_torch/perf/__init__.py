"""Analytic per-cell cost model (`costmodel`) and the card's constants."""
from . import costmodel  # noqa: F401
