"""IPM iterations committed in the window over the solves in it."""


def read(run):
    if not run.solves:
        return None
    return sum(s.iterations for s in run.solves) / len(run.solves)
