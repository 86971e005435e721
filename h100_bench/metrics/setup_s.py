"""setup_s (s, host clock): from the start of the process to the window's
opening: imports, CUDA init, kernel libraries (built on the first run of a
checkout), weights, conversion, warm-up."""


def read(run):
    return run.setup_s
