"""Process start to the window's first step: imports, kernel libraries,
weights, the token table and its store, the loader and the checked steps."""


def read(run):
    return run.setup_s
