"""Serving: the engine's phases, the paged KV pool and the
continuous-batching scheduler."""
from . import engine  # noqa: F401
from . import pool  # noqa: F401
from . import scheduler  # noqa: F401
