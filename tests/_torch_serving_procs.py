"""The leak guard of the port's process-tier tests
(``test_torch_serving_{fleet,control_plane,autoscale,scheduler}.py``).

The suite's own guards (``tests/conftest.py``) watch only the JAX package's
pid tables; this one watches the port's: no worker or router process
launched through ``deeplearning4j_tpu_torch.serving.fleet`` /
``.control_plane`` may outlive its supervisor. Survivors are killed and
fail the test.
"""

import sys
import time

import pytest

_TABLES = (("deeplearning4j_tpu_torch.serving.fleet", "orphaned_worker_pids",
            "kill_orphaned_workers"),
           ("deeplearning4j_tpu_torch.serving.control_plane", "orphaned_router_pids",
            "kill_orphaned_routers"))


@pytest.fixture(autouse=True)
def port_process_guard():
    yield
    leaks = []
    for name, pid_fn, kill_fn in _TABLES:
        mod = sys.modules.get(name)
        if mod is None:
            continue
        deadline = time.monotonic() + 5.0
        while getattr(mod, pid_fn)() and time.monotonic() < deadline:
            time.sleep(0.05)
        if getattr(mod, pid_fn)():
            leaks.append((name, getattr(mod, kill_fn)()))
    assert not leaks, f"orphaned port processes leaked: {leaks}"
