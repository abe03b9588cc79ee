"""setup_s: seconds from the process's start to the window's: imports,
kernel libraries built or loaded, weights made, the engine built, graphs
captured, warm-up."""


def read(run):
    return run.setup_s
