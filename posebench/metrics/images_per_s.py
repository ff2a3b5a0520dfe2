"""Images whose humans the window returned, over the window's wall time."""

UNIT = "images/s"


def read(ctx):
    return ctx["outcome"]["images"] / ctx["outcome"]["window_s"]
