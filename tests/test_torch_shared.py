"""One computation shared by the pytest-xdist workers of a run (no tests).

The port's tests hold it against JAX results that take a minute or more to
compute on the CPU (a jitted JAX model, a whole JAX CLI run).  Under
``pytest -n N --dist load`` every worker that takes one of a module's tests
sets up that module's fixtures again, so such a result would be computed by
up to N workers.  :func:`shared_result` computes it once: the first worker
to ask computes it under a file lock and pickles it into the run's shared
temporary directory; the others wait on the lock and load it.  Outside
xdist it just computes.  The results are plain data (numpy arrays, lists,
dicts, numbers), identical to what each worker would have computed.
"""

from __future__ import annotations

import fcntl
import os
import pickle


def shared_result(name: str, compute, tmp_path_factory):
    """``compute()``, once a test run across the xdist workers, keyed by
    ``name`` (unique within the run)."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None:
        return compute()
    root = tmp_path_factory.getbasetemp().parent / f"shared-{run}"
    root.mkdir(exist_ok=True)
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            value = compute()
            part = root / f"{name}.part"
            with open(part, "wb") as f:
                pickle.dump(value, f)
            part.replace(path)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
