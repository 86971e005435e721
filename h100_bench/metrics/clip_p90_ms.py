"""clip_p90_ms (ms, host clock): the 90th percentile (linear between order
statistics) of the call walls of every item of the window."""

import numpy as np


def read(run):
    walls = run.walls_s()
    return float(np.percentile(walls, 90)) * 1e3 if walls else None
