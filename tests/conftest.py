"""Suite-wide pytest config.

1. Registers the ``slow`` marker used by the multi-device SPMD test.
2. Installs a deterministic fallback shim for ``hypothesis`` when the
   real package is unavailable (offline CI containers): the property
   tests then run their example-based paths against a fixed, per-test
   seeded stream instead of being collection errors.  With the real
   package installed the shim never activates.
"""
from __future__ import annotations

import sys

# guard fixtures (recompile_guard, host_sync_sanitizer, ...) live next to
# the linter so the waiver allowlist and the runtime allowlist stay one
# artifact; `tools` resolves via pythonpath = ["src", "."] in pyproject
pytest_plugins = ("tools.lint.pytest_plugin",)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tests (multi-device subprocess runs)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped without one")


# ---------------------------------------------------------------------------
# hypothesis fallback shim
# ---------------------------------------------------------------------------

def _install_hypothesis_shim():
    import functools
    import inspect
    import random
    import types
    import zlib

    class Strategy:
        """Deterministic value source.  ``example(rng, i)`` returns a
        boundary value for i == 0 and a pseudo-random draw otherwise."""

        def __init__(self, boundary, draw):
            self._boundary = boundary
            self._draw = draw

        def example(self, rng, i):
            return self._boundary() if i == 0 else self._draw(rng)

    def integers(min_value=None, max_value=None):
        lo = -2**63 if min_value is None else int(min_value)
        hi = 2**63 - 1 if max_value is None else int(max_value)
        return Strategy(lambda: lo, lambda rng: rng.randint(lo, hi))

    def floats(min_value=None, max_value=None, **_kw):
        lo = 0.0 if min_value is None else float(min_value)
        hi = 1.0 if max_value is None else float(max_value)
        return Strategy(lambda: lo, lambda rng: rng.uniform(lo, hi))

    def sampled_from(elements):
        elems = list(elements)
        return Strategy(lambda: elems[0],
                        lambda rng: elems[rng.randrange(len(elems))])

    def booleans():
        return sampled_from([False, True])

    def just(value):
        return Strategy(lambda: value, lambda rng: value)

    def settings(*_args, **kwargs):
        def deco(fn):
            fn._shim_max_examples = kwargs.get("max_examples", 10)
            return fn
        return deco

    settings.register_profile = lambda *a, **k: None
    settings.load_profile = lambda *a, **k: None

    def given(*strats):
        def deco(fn):
            n_examples = getattr(fn, "_shim_max_examples", 10)
            sig = inspect.signature(fn)
            params = list(sig.parameters.values())
            keep = params[:len(params) - len(strats)]
            # the trailing params are strategy-bound; fill them by NAME so
            # pytest passing fixtures/parametrize args as kwargs still works
            strat_names = [p.name for p in params[len(params) - len(strats):]]

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                rng = random.Random(zlib.crc32(fn.__qualname__.encode()))
                for i in range(n_examples):
                    vals = tuple(s.example(rng, i) for s in strats)
                    try:
                        fn(*args, **kwargs,
                           **dict(zip(strat_names, vals)))
                    except Exception as e:
                        raise AssertionError(
                            f"hypothesis-shim falsifying example "
                            f"#{i}: {vals!r}") from e

            # hide the strategy-bound params from pytest's fixture
            # resolution (like real hypothesis does)
            wrapper.__signature__ = sig.replace(parameters=keep)
            return wrapper
        return deco

    def assume(condition):
        return bool(condition)

    hyp = types.ModuleType("hypothesis")
    hyp.__shim__ = True
    st_mod = types.ModuleType("hypothesis.strategies")
    for name, obj in [("integers", integers), ("floats", floats),
                      ("sampled_from", sampled_from), ("booleans", booleans),
                      ("just", just)]:
        setattr(st_mod, name, obj)
    hyp.strategies = st_mod
    hyp.given = given
    hyp.settings = settings
    hyp.assume = assume
    hyp.HealthCheck = types.SimpleNamespace(
        too_slow="too_slow", data_too_large="data_too_large",
        filter_too_much="filter_too_much")
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st_mod


try:
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_shim()
