"""Set-up: from the process's start to the first event of the window."""


def read(run):
    return run.setup_s
