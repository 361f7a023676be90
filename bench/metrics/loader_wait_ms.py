"""Mean host milliseconds a window step waited in the loader's next()."""


def read(run):
    w = run.window.loader_wait_s
    return 1e3 * sum(w) / len(w) if w else None
