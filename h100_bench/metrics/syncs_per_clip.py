"""syncs_per_clip (syncs/clip, program spans): the program's ``sesa.sync.*``
spans inside the calls, per clip: each is a place where the host waits for
the device (the rescue flag, the stems' copy to the host) (spans.py)."""

from h100_bench import spans


def read(run):
    return spans.syncs_per_call(run)
