"""host_ms_per_clip (ms/clip, device trace): per item, its call's span less
the union of device activity inside it, averaged: the time the card waited
on the host inside a call."""


def read(run):
    spans = run.trace.spans
    if not spans:
        return None
    idle = [(e - s) - run.trace.busy_us(s, e) for _, s, e in spans]
    return sum(idle) / len(idle) / 1e3
