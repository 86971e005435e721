"""launches_per_chunk (launches/chunk, device trace): kernels the device ran
in the window per chunk computed."""


def read(run):
    chunks = run.item_chunks()
    return run.trace.kernel_count() / chunks if chunks else None
