"""Set-up seconds: from the interpreter's start to the window's, the
pool made, the program built and one warm pass or replay run (the
harness's clock)."""


def read(ctx):
    return ctx["setup_s"]
