"""Set-up: from the process start to the first timed frame (imports,
the CUDA context, the kernels' build or load, rendering the inputs on
the card, the program's objects, graph captures and warm-up)."""


def read(r):
    return r.setup_s
