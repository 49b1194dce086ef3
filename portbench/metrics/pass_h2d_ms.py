"""The host-to-device copies of an archive pass: their traced time
over the window's passes, in milliseconds."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["jobs"]:
        return None
    spent = sum(v for k, v in tr["copies"].items() if "HtoD" in k)
    if not spent:
        return None
    return 1000.0 * spent / ctx["jobs"]
