"""``launches_per_eval``: device operations of every kind (kernels, copies,
sets) in the traced outer iterations per loss+grad evaluation made there:
the host dispatch the ``ops/*`` wrappers and ``ops/backend.py`` cost."""


def read(run):
    tr = run.get("trace")
    if not tr or not tr["evals"]:
        return None
    return len(tr["events"]) / tr["evals"]
