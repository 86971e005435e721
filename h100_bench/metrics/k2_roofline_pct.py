"""k2_roofline_pct (%, device trace): the time K2's launches of the
window need at the roofline (models/<model_type>.py, launch shapes from
each item's length and the demix settings) over the device time of K2's
kernels (kernels/K2.json). Silent where K2 did not launch."""


def read(run):
    measured = run.trace.families.get("K2", 0.0) * 1e-6
    if measured <= 0 or run.launches.get("K2", 0) == 0:
        return None
    return 100.0 * run.kernel_bound_s("K2") / measured
