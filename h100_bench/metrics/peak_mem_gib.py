"""peak_mem_gib (GiB): torch.cuda.max_memory_allocated() over the window,
reset when it opens."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
