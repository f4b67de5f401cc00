"""``setup_s``: from the process's start to the window's first job: imports, the card, the world
(rendered by a cell's first run, loaded by the others), staging, and the warm job."""


def read(run):
    return run.setup_s
