"""The CollaFuse trainer on (data, model) meshes of gloo processes on the
CPU (``CollaFuseTrainer(mesh=)``), against the one-process trainer, which
``test_torch_train.py`` holds against the reference.

A module fixture starts a 2x1 and a 1x2 world at once
(``tests/_torch_trainer_mesh_worker.py``, a process a rank, one thread
each); each trains 2 labeled rounds with 4 clients (a block of client
stacks a data rank, the pooled server batch a block of rows) and with 3
(the stacks replicated, the pool still split), and saves its checkpoint.
Each world's losses and state are held against the one-process trainer
(in this process, at its own thread count, so its convolutions may sum
in another order): the losses to :data:`LOSS_TOL`, the parameters to
:data:`PARAM_TOL` (the data ranks' server gradients are also summed in
another order); the server parameters are
the same bits on every rank; the checkpoint restores on one process.  The
launcher's mesh form runs too."""
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import set_torch_cpu  # noqa: E402
from _torch_trainer_mesh_worker import (CLIENTS, ROUNDS, run,  # noqa: E402
                                        trainer)
from repro_torch.launch import clients_sweep  # noqa: E402

set_torch_cpu()

REPO = Path(__file__).resolve().parents[1]
WORLDS = {"2x1": 2, "1x2": 2}
# float32 sums in another order (the server's gradient the ranks' block
# means all-reduced), which AdamW (lr 1e-3) carries into the weights
PARAM_TOL = dict(rtol=0, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start both worlds, train the one-process trainers meanwhile; returns
    (output dir, a failed rank's stderr or None, {n: one-process outputs,
    its trainer})."""
    root = tmp_path_factory.mktemp("trainer_mesh")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    for world, size in WORLDS.items():
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable,
             str(REPO / "tests" / "_torch_trainer_mesh_worker.py"), "--dims",
             world, "--rank", str(r), "--port", str(port), "--dir",
             str(root)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
            for r in range(size)]
    one = {}
    for n in CLIENTS:
        tr = trainer(n)
        one[n] = (run(tr, n), tr)
    deadline = time.monotonic() + 300
    err = None
    for p in procs:
        try:
            _, e = p.communicate(timeout=max(1.0, deadline -
                                             time.monotonic()))
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            _, e = p.communicate()
        if p.returncode:
            err = e[-3000:]
    return root, err, one


def _ranks(worlds, world, n):
    root, err, _ = worlds
    assert err is None, err
    return [np.load(root / world / f"{n}.rank{r}.npz")
            for r in range(WORLDS[world])]


@pytest.mark.parametrize("n", CLIENTS)
@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_trainer_matches_one_process(worlds, world, n):
    want = worlds[2][n][0]
    ranks = _ranks(worlds, world, n)
    assert bool(ranks[0]["stacks_sharded"]) == (world == "2x1" and n == 4)
    for out in ranks:
        for r in range(ROUNDS):
            np.testing.assert_allclose(out[f"server_loss.{r}"],
                                       want[f"server_loss.{r}"], **LOSS_TOL)
            # every rank returns all n client losses
            np.testing.assert_allclose(out[f"client_losses.{r}"],
                                       want[f"client_losses.{r}"],
                                       **LOSS_TOL)
        for k in want:
            if k.startswith(("clients.", "server.")):
                np.testing.assert_allclose(out[k], want[k], **PARAM_TOL,
                                           err_msg=k)


@pytest.mark.parametrize("n", CLIENTS)
@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_trainer_server_params_bitwise_across_ranks(worlds, world, n):
    a, b = _ranks(worlds, world, n)
    for k in a.files:
        if k.startswith("server."):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("n", CLIENTS)
def test_mesh_checkpoint_restores_on_one_process(worlds, n):
    """The 2x1 world's checkpoint (gathered, written by rank 0) restores
    into a one-process trainer: its state is rank 0's, and its next round
    is the one-process trainer's next round."""
    root = worlds[0]
    out = _ranks(worlds, "2x1", n)[0]
    tr = trainer(n)
    tr.restore(str(root / "2x1" / f"{n}.ckpt.npz"))
    assert tr.round == ROUNDS
    for k, v in tr.server_params.items():
        np.testing.assert_array_equal(v.numpy(), out["server." + k])
    for k, v in tr.client_stack.items():
        np.testing.assert_array_equal(v.numpy(), out["clients." + k])


def test_clients_sweep_on_a_mesh(capfd, tmp_path):
    path = tmp_path / "sweep.json"
    clients_sweep.main(["--device", "cpu", "--devices", "2", "--mesh-shape",
                        "2x1", "--clients", "2", "3", "--rounds", "1",
                        "--T", "10", "--json", str(path)])
    out = capfd.readouterr().out
    assert "clients_sweep: mesh=data:2xmodel:1" in out
    assert "clients sweep OK: 2 points" in out
    import json
    recs = json.loads(path.read_text())
    assert [r["n_clients"] for r in recs] == [2, 3]
    assert all(r["mesh"] == "2x1" for r in recs)
