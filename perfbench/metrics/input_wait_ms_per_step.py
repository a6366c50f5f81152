"""Host ms a step that the window's steps spent taking their batch from
the input pipeline (the benchmark's timed range around ``next`` on the
loader, prefetch and placement)."""


def read(run):
    if not run.window_pulls:
        return None
    return run.input_wait_s * 1e3 / run.window_pulls
