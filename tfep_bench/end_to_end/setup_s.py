"""Seconds from the process's start to the window's: imports, frames and
weights from the seed, the map's ``setup()``, the first steps."""


def read(run):
    return run['setup_s']
