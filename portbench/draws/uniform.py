"""Keys drawn uniformly over the configuration's key indices."""


def draw(rng, n, count, group=0, groups=1):
    """n key indices drawn uniformly over those of 0 .. count - 1 with
    index % groups == group."""
    span = (count - group + groups - 1) // groups
    return group + groups * rng.integers(0, span, n)
