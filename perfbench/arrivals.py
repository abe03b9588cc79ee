"""Open-loop arrival times, in seconds from the window's start, from a
traffic file's `arrivals`:

    {"kind": "poisson", "rate_per_s": 70.0}

The gaps of a unit-rate Poisson process are exponential; every seed takes
the same set of them, the exponential's quantiles at (i + 0.5) / n, in an
order the seed shuffles, so two seeds offer the same amount of work in
another order, as many requests over the window."""

from __future__ import annotations

import numpy as np


def due_times(spec: dict, seed: int, seconds: float) -> np.ndarray:
    """The sorted due times in [0, seconds): n = the expected arrivals over
    the window, the same n for every seed, spread over the whole window by
    gaps drawn as above (n + 1 of them, the last one past the close) and
    scaled to it by the same factor for every seed."""
    rate = float(spec["rate_per_s"])
    work = rate * seconds
    n = int(round(work))
    u = (np.arange(n + 1) + 0.5) / (n + 1)
    gaps = -np.log1p(-u)                     # unit-rate exponential quantiles
    np.random.default_rng([int(seed), 11]).shuffle(gaps)
    at = np.cumsum(gaps)[:n] * (work / gaps.sum())
    return np.minimum(at / rate, np.nextafter(seconds, 0.0))
