"""Multi-process data parallelism of the port over ``torch.distributed``
gloo on the CPU (``tests/test_multihost.py`` and
``tests/test_fault_tolerance_multihost.py``).

- Two processes join through ``initialize_multihost``, each computes its
  shard's gradient of a softmax regression, and the gradients are gathered
  (``CollectiveExchange``) and summed in rank order: both processes hold
  the same gradient, BITWISE equal to the single-process step over the two
  shards, and within ``1e-6`` of the whole batch's gradient in torch and in
  JAX.
- Fault tolerance: worker 1 dies at round 3, the test's
  ``HeartbeatMonitor`` (or the exit code) notices, the survivor is killed,
  the group re-forms on a fresh port, restores rank 0's checkpoint and
  finishes; the final weights equal the uninterrupted single-process run
  BITWISE, the loss tail too.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.train.distributed import free_port, worker_env
from deeplearning4j_tpu_torch.train.fault_tolerance import HeartbeatMonitor, TrainingFailure

_STEP = r"""
import numpy as np
import torch


def data(seed=0):
    rng = np.random.default_rng(seed)
    W = rng.normal(0, 0.5, (8, 4)).astype(np.float32)
    X = rng.normal(0, 1, (16, 8)).astype(np.float32)
    Y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    return W, X, Y


def shard_grad(W, X, Y, rank, world):
    n = X.shape[0] // world
    w = torch.from_numpy(W).requires_grad_(True)
    x, y = torch.from_numpy(X[rank * n:(rank + 1) * n]), torch.from_numpy(Y[rank * n:(rank + 1) * n])
    loss = -(torch.log_softmax(x @ w, -1) * y).sum(-1).mean()
    (g,) = torch.autograd.grad(loss, w)
    return g.numpy() / np.float32(world)


def rank_sum(parts):
    out = np.zeros_like(parts[0])
    for p in parts:
        out += p
    return out
"""

_WORKER = _STEP + r"""
import json, sys
from deeplearning4j_tpu_torch.runtime.mesh import (initialize_multihost, process_count,
                                                   process_index, shutdown_multihost)
from deeplearning4j_tpu_torch.train.distributed import CollectiveExchange

rank = int(sys.argv[1]); world = int(sys.argv[2]); port = sys.argv[3]
initialize_multihost(f"127.0.0.1:{port}", world, rank)
assert process_count() == world and process_index() == rank
W, X, Y = data()
ex = CollectiveExchange()
frames = ex.gather_bytes(shard_grad(W, X, Y, rank, world).tobytes())
g = rank_sum([np.frombuffer(f, np.float32).reshape(8, 4) for f in frames])
print("GRAD" + json.dumps({"hex": g.tobytes().hex()}), flush=True)
shutdown_multihost()
"""

_FT_WORKER = _STEP + r"""
import json, os, sys
from deeplearning4j_tpu_torch.runtime.mesh import initialize_multihost
from deeplearning4j_tpu_torch.train.distributed import CollectiveExchange

rank = int(sys.argv[1]); world = int(sys.argv[2]); port = sys.argv[3]
ckpt_dir = sys.argv[4]; epochs = int(sys.argv[5]); crash_at = int(sys.argv[6])
hb_file = sys.argv[7]
initialize_multihost(f"127.0.0.1:{port}", world, rank)
ex = CollectiveExchange()
W, _, _ = data()
ckpt = os.path.join(ckpt_dir, "state.npz")
start = 0
if os.path.exists(ckpt):
    blob = np.load(ckpt)
    W, start = blob["W"], int(blob["epoch"]) + 1
losses = []
for epoch in range(start, epochs):
    if rank == 1 and epoch == crash_at:
        os._exit(17)  # a lost worker mid-round
    erng = np.random.default_rng(100 + epoch)
    X = erng.normal(0, 1, (16, 8)).astype(np.float32)
    Y = np.eye(4, dtype=np.float32)[erng.integers(0, 4, 16)]
    frames = ex.gather_bytes(shard_grad(W, X, Y, rank, world).tobytes())
    W = W - np.float32(0.1) * rank_sum([np.frombuffer(f, np.float32).reshape(8, 4)
                                        for f in frames])
    losses.append(float(-(torch.log_softmax(torch.from_numpy(X) @ torch.from_numpy(W), -1)
                          * torch.from_numpy(Y)).sum(-1).mean()))
    with open(hb_file, "w") as f:
        f.write(str(epoch))
    if rank == 0:
        tmp = ckpt + ".tmp.npz"
        np.savez(tmp, W=W, epoch=epoch)
        os.replace(tmp, ckpt)
print("DONE" + json.dumps({"W": W.tobytes().hex(), "losses": losses}), flush=True)
"""


def _step_module():
    ns = {}
    exec(_STEP, ns)
    return ns


def _spawn(script, args, tmp_path, name):
    wfile = tmp_path / name
    wfile.write_text(script)
    return [subprocess.Popen([sys.executable, str(wfile), str(rank)] + args(rank),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=worker_env(),
                             text=True) for rank in range(2)]


def _reap(procs, prefix, timeout=120):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            line = [l for l in out.splitlines() if l.startswith(prefix)]
            assert line, out
            outs.append(json.loads(line[0][len(prefix):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    return outs


def test_two_process_dp_grads_equal_the_single_process_step(tmp_path):
    port = free_port()
    procs = _spawn(_WORKER, lambda r: ["2", port], tmp_path, "worker.py")
    outs = _reap(procs, "GRAD")
    assert outs[0]["hex"] == outs[1]["hex"]
    step = _step_module()
    W, X, Y = step["data"]()
    single = step["rank_sum"]([step["shard_grad"](W, X, Y, r, 2) for r in range(2)])
    assert outs[0]["hex"] == single.tobytes().hex()
    whole = step["shard_grad"](W, X, Y, 0, 1)
    np.testing.assert_allclose(single, whole, rtol=1e-6, atol=1e-6)
    import jax
    import jax.numpy as jnp

    def loss(w, x, y):
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(x @ w) * y, axis=-1))

    np.testing.assert_allclose(single, np.asarray(jax.grad(loss)(W, X, Y)), rtol=1e-6,
                               atol=1e-6)


def test_worker_death_detected_restored_and_completes(tmp_path):
    ckpt_dir = tmp_path / "ckpts"
    ckpt_dir.mkdir()
    hb = [tmp_path / f"hb{i}" for i in range(2)]
    EPOCHS, CRASH_AT = 6, 3

    def args(crash_at, port):
        return lambda r: ["2", port, str(ckpt_dir), str(EPOCHS), str(crash_at), str(hb[r])]

    # round 1: worker 1 dies at epoch 3; the monitor or the exit code notices
    procs = _spawn(_FT_WORKER, args(CRASH_AT, free_port()), tmp_path, "ft.py")
    monitor = HeartbeatMonitor(timeout_s=25.0)
    seen, failure = {}, None
    deadline = time.time() + 120
    try:
        while time.time() < deadline:
            for i, f in enumerate(hb):
                if f.exists() and seen.get(i) != f.stat().st_mtime:
                    seen[i] = f.stat().st_mtime
                    monitor.beat()
            if any(p.poll() not in (None, 0) for p in procs):
                failure = TrainingFailure("worker process died")
                break
            try:
                monitor.check()
            except TrainingFailure as e:
                failure = e
                break
            if all(p.poll() == 0 for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=30)
    assert failure is not None
    assert int(np.load(ckpt_dir / "state.npz")["epoch"]) == CRASH_AT - 1

    # round 2: re-form on a fresh port, restore, finish
    outs = _reap(_spawn(_FT_WORKER, args(-1, free_port()), tmp_path, "ft.py"), "DONE")
    assert outs[0]["W"] == outs[1]["W"]
    assert len(outs[0]["losses"]) == EPOCHS - CRASH_AT

    # the uninterrupted single-process run of the same schedule
    step = _step_module()
    W, _, _ = step["data"]()
    tail = []
    for epoch in range(EPOCHS):
        erng = np.random.default_rng(100 + epoch)
        X = erng.normal(0, 1, (16, 8)).astype(np.float32)
        Y = np.eye(4, dtype=np.float32)[erng.integers(0, 4, 16)]
        W = W - np.float32(0.1) * step["rank_sum"](
            [step["shard_grad"](W, X, Y, r, 2) for r in range(2)])
        tail.append(float(-(torch.log_softmax(torch.from_numpy(X) @ torch.from_numpy(W), -1)
                            * torch.from_numpy(Y)).sum(-1).mean()))
    assert outs[0]["W"] == W.tobytes().hex()
    assert outs[0]["losses"] == tail[CRASH_AT:]
