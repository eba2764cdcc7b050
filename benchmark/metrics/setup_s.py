"""setup_s: seconds from the start of the process to the first timed
step or call (imports, inputs and weights made from the seed, the program's
set-up, kernel builds on a checkout's first run, warm-up)."""


def read(run):
    return run.setup_s
