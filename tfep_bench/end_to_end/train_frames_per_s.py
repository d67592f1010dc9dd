"""Frames trained in the window over the window's time (a training run)."""


def read(run):
    if run['entry'] != 'fit' or run['window_s'] <= 0:
        return None
    return run['frames'] / run['window_s']
