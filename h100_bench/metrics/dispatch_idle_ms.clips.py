"""dispatch_idle_ms.clips (ms/clip, program spans): per clip, the device's idle
time from the start of the call's first ``sesa.dispatch`` span to the end of
its last: the host not keeping the card fed while it queues the model calls
(spans.py)."""

from h100_bench import spans


def read(run):
    return spans.idle_ms_per_call(run, 1)
