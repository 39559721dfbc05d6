"""Process start to the first measured op: the kernel library's load (its
build, in a checkout's first run), the parameters, the inputs, the warm-up."""


def read(run):
    return run.setup_s
