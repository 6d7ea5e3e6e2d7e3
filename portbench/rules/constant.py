"""The same value for every key."""

import numpy as np


def values(idx, value):
    return np.full(len(idx), int(value), np.int64)
