"""Keys drawn by Zipf's law: key index r (its rank) has weight
(r + 1)^-a over 0 .. count - 1."""

import numpy as np

_weights = {}


def draw(rng, n, count, group=0, groups=1, a=1.0):
    """n key indices of rank weight (r + 1)^-a, conditioned on index %
    groups == group (each group keeps its own keys' weights)."""
    if (count, a) not in _weights:
        _weights[count, a] = np.arange(1, count + 1, dtype=np.float64) ** -a
    span = (count - group + groups - 1) // groups
    cdf = np.cumsum(_weights[count, a][group::groups])
    j = np.searchsorted(cdf, rng.random(n) * cdf[-1], side="right")
    return group + groups * np.minimum(j, span - 1)
