"""post_idle_ms.clips (ms/clip, program spans): per clip, the device's idle time
from the end of the call's last ``sesa.dispatch`` span to the call's end:
the rescue flag, the stems' copy to the host, the derived stems
(``sesa.extras``) (spans.py)."""

from h100_bench import spans


def read(run):
    return spans.idle_ms_per_call(run, 2)
