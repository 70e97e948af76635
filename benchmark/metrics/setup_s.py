"""Process start to the first timed call: imports, the CUDA context, the
libraries loaded from the build cache, the inputs made from the seed, the
warm-up call."""


def read(run):
    return run.setup_s
