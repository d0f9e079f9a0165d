"""Process start to the window's start: CUDA context, inputs and GT, the
program's model and tables, the check steps that build and warm every
kernel."""


def read(run):
    return run.setup_s
