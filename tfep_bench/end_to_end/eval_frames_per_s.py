"""Frames whose work values ``run_evaluation`` returned to the host in the
window, over the window's time (an evaluation run)."""


def read(run):
    if run['entry'] != 'evaluate' or run['window_s'] <= 0:
        return None
    return run['frames'] / run['window_s']
