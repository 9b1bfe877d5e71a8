"""Set-up seconds: from the process's start to the window's: the
interpreter, torch and CUDA, the kernel library's build or load, the
weights and the warm-up of every shape the cell uses."""


def read(run):
    return run.facts.get("setup_s")
