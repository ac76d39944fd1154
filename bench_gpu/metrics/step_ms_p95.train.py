"""The 95th percentile of every step wall of the training window (each
step ends in the engine's synchronize), linear between order statistics:
the tail that host hiccups on a shared host make, kept beside the rate
with no bound."""

import numpy as np


def read(run):
    walls = run.window.get("walls")
    if not walls:
        return None
    return 1e3 * float(np.percentile(np.asarray(walls, np.float64), 95))
