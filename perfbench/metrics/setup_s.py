"""Set-up seconds: from the start of the process to the window's start
(interpreter, torch and CUDA, the kernel library, each instance's build,
compile and warm solve with its graph capture)."""


def read(run):
    return run.setup_s
