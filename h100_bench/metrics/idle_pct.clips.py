"""Device idle share (%, device trace): 1 - the union of device activity
(kernels, copies, sets) inside the calls over the calls' spans; the
harness's work between calls is left out."""


def read(run):
    window = run.trace.window_us()
    return 100.0 * (1.0 - run.trace.busy_us() / window) if window > 0 else None
