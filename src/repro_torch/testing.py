"""Property-test compatibility layer — the port's own copy of
``repro/testing.py``, with the same API (``given``, ``settings``, ``st``,
``HAVE_HYPOTHESIS``), so the port's property tests need nothing of the JAX
package.

The property tests are written against the ``hypothesis`` API.
Environments without hypothesis get a small deterministic fallback that
draws seeded examples per strategy, always including both interval
endpoints, so the properties still execute everywhere instead of skipping.

Usage (drop-in for the hypothesis names used here):

    from repro_torch.testing import given, settings, st
"""
from __future__ import annotations

try:  # pragma: no cover - exercised only where hypothesis is installed
    from hypothesis import given, settings, strategies as st  # noqa: F401

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

    import functools
    import inspect

    import numpy as np

    class _Ints:
        def __init__(self, lo: int, hi: int):
            self.lo, self.hi = int(lo), int(hi)

        def draw(self, rng, i: int):
            if i == 0:
                return self.lo
            if i == 1:
                return self.hi
            return int(rng.integers(self.lo, self.hi + 1))

    class _Floats:
        def __init__(self, lo: float, hi: float):
            self.lo, self.hi = float(lo), float(hi)

        def draw(self, rng, i: int):
            if i == 0:
                return self.lo
            if i == 1:
                return self.hi
            return float(rng.uniform(self.lo, self.hi))

    class _Sampled:
        def __init__(self, elements):
            self.elements = list(elements)

        def draw(self, rng, i: int):
            if i < len(self.elements):  # cover every element first
                return self.elements[i]
            return self.elements[int(rng.integers(0, len(self.elements)))]

    class st:  # noqa: N801 - mimics hypothesis.strategies
        @staticmethod
        def integers(min_value: int, max_value: int) -> _Ints:
            return _Ints(min_value, max_value)

        @staticmethod
        def floats(min_value: float, max_value: float) -> _Floats:
            return _Floats(min_value, max_value)

        @staticmethod
        def booleans() -> "_Sampled":
            return _Sampled([False, True])

        @staticmethod
        def sampled_from(elements) -> "_Sampled":
            return _Sampled(elements)

    def settings(max_examples: int = 10, deadline=None, **_ignored):
        def deco(fn):
            fn._max_examples = max_examples
            return fn

        return deco

    def given(**strategies):
        def deco(fn):
            sig = inspect.signature(fn)
            kept = [
                p for name, p in sig.parameters.items()
                if name not in strategies
            ]

            @functools.wraps(fn)
            def wrapper(**fixture_kwargs):
                n = getattr(wrapper, "_max_examples", 10)
                rng = np.random.default_rng(0)
                for i in range(n):
                    drawn = {
                        name: strat.draw(rng, i)
                        for name, strat in strategies.items()
                    }
                    fn(**fixture_kwargs, **drawn)

            # hide strategy params from pytest's fixture resolution
            wrapper.__signature__ = sig.replace(parameters=kept)
            return wrapper

        return deco
