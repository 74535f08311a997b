"""``evals_per_iter``: loss+grad evaluations per outer iteration in the window
(the lockstep count of ``lossgrad_ms``)."""


def read(run):
    return run["evals"] / run["iterations"] if run["iterations"] else None
