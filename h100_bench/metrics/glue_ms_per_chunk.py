"""glue_ms_per_chunk (ms/chunk, device trace): device time of the kernels
that are not the program's own (no ``sesa::`` in the name; copies and sets
left out) per chunk the window computed: STFT and iSTFT, band split, mask
estimator, norms, casts and the demix's overlap-add."""


def read(run):
    chunks = run.item_chunks()
    glue = run.trace.kind_us("kernel") - run.trace.sesa_kernel_us()
    return glue / 1e3 / chunks if chunks else None
