"""pre_idle_ms.clips (ms/clip, program spans): per clip, the device's idle time
from the call's start to its first ``sesa.dispatch`` span: the mix's upload
(``sesa.upload``) and what the session does before demix (spans.py)."""

from h100_bench import spans


def read(run):
    return spans.idle_ms_per_call(run, 0)
