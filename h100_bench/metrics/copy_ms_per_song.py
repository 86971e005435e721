"""copy_ms_per_song (ms/song, device trace): device time of the host-device
copies (Memcpy HtoD and DtoH rows) of the window, per item: the upload of
the song, the stems' way back to host memory, the per-call tables."""


def read(run):
    us = run.trace.kind_us("memcpy", ("Memcpy HtoD", "Memcpy DtoH"))
    return us / 1e3 / len(run.items) if run.items else None
