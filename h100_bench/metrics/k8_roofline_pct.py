"""k8_roofline_pct (%, device trace): the time K8's launches of the window
need at the roofline (models/<model_type>.py, launch shapes from each item's
length and the demix settings) over the device time of K8's kernels
(kernels/K8.json). Silent where K8 did not launch."""


def read(run):
    measured = run.trace.families.get("K8", 0.0) * 1e-6
    if measured <= 0 or run.launches.get("K8", 0) == 0:
        return None
    return 100.0 * run.kernel_bound_s("K8") / measured
