"""base + key index % span: values spread evenly over span steps."""

import numpy as np


def values(idx, base, span):
    return int(base) + np.asarray(idx, np.int64) % int(span)
