"""The batch driver's wait on its prefetch thread's window read
(``LFProc.timings["assemble_s"]``) as a share of the passes' wall."""


def read(ctx):
    wait = ctx["timings"].get("assemble_s")
    walls = sum(ctx["walls"])
    if wait is None or not walls:
        return None
    return 100.0 * wait / walls
