"""render_fps: frames rendered and copied to the host in the measured
window, over the window's seconds (host clock)."""


def read(run):
    if run.kind != "render":
        return None
    return run.window["frames"] / run.window["seconds"]
