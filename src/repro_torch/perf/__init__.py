"""Analytic per-cell cost model (`costmodel`) and the card's constants,
and the named spans of the codec path (`trace`).  Import each by name:
the codec path imports `trace` and must not pull in the cost model's
model configurations."""
