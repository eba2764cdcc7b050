"""train_steps_s: optimizer steps completed in the measured window, over
the window's seconds (host clock, the window closed by a synchronize)."""


def read(run):
    if run.kind != "train":
        return None
    return run.window["steps"] / run.window["seconds"]
