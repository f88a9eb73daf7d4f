"""Pod mode across processes on the CPU: two ``repro_torch.launch.pod_smoke``
processes joined by a gloo group against the in-process single host (the
union of their owned rows bitwise, retire ticks equal, with the client
segment in both finish modes, wave packing, guided pairs across the two
blocks, and one trace track a host), and ``serve_diffusion --devices 2
--mesh-shape 2x1`` and ``1x2`` against ``--devices 1``.  Every child has a time limit,
and its whole process group is killed when the limit runs out."""
import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.launch import pod_smoke  # noqa: E402
from repro_torch.launch import serve_diffusion  # noqa: E402
from repro_torch.obs import load_trace, merge_traces  # noqa: E402
from repro_torch.serve import ObsConfig  # noqa: E402

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 180
# 7 requests at 8 slots put request 5's two guided pairs across the blocks
REQUESTS = 7


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_children(cmds, timeout=CHILD_TIMEOUT_S):
    """Start every command at once (each in its own session, from src/) and
    wait for all; at the deadline kill every one's process group."""
    # two threads a child, as the test process: the suite runs six workers
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([str(c) for c in cmd], cwd=REPO / "src",
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True) for cmd in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _straddling(res, block):
    out = []
    for rid, events in sorted(res.timelines.items()):
        b = res.completions[rid].request.batch
        for e in events:
            if e["stage"] == "admitted" and len(e.get("lanes", ())) == 2 * b:
                ln = e["lanes"]
                out += [(rid, ln[i], ln[b + i]) for i in range(b)
                        if ln[i] // block != ln[b + i] // block]
    return out


@pytest.mark.parametrize("mode,pack,trace", [("stream", True, True),
                                             ("drain", True, False),
                                             ("stream", False, False)])
def test_two_process_pod_smoke_is_bitwise_the_single_host(tmp_path, mode,
                                                          pack, trace):
    flags = ["--device", "cpu", "--slots", 8, "--requests", REQUESTS,
             "--clients", 2, "--finish-mode", mode]
    flags += ["--pack"] if pack else []
    trace_path = tmp_path / "trace.json"
    flags += ["--trace-out", trace_path] if trace else []
    port = _free_port()
    outs = run_children([
        [sys.executable, "-m", "repro_torch.launch.pod_smoke",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", 2,
         "--process-id", h, "--out", tmp_path / f"pod{h}.json", *flags]
        for h in (0, 1)])
    assert all("pod_smoke OK" in o for o in outs)
    arts = [json.loads((tmp_path / f"pod{h}.json").read_text())
            for h in (0, 1)]
    single = pod_smoke.serve_pod(
        1, 0, 8, REQUESTS, 4, 2, clients=2, finish_mode=mode, pack=pack,
        device="cpu", obs=ObsConfig(trace=False, timelines=True))
    assert _straddling(single, 4) == [(5, 2, 4), (5, 3, 5)]
    ref = pod_smoke.artifact(single, 0)
    union = pod_smoke.union(arts)
    for rid, rec in ref["completions"].items():
        assert union["completions"][rid]["retire_tick"] == rec["retire_tick"]
        assert union["completions"][rid]["owned"] == rec["owned"]
        assert sorted(rec["x0_rows"]) == sorted(rec["rows"])
    assert union == ref
    # each host owns its block: rows of both hosts in the union
    assert all(any(a["completions"][r]["owned"] for r in a["completions"])
               for a in arts)
    if trace:
        merged = tmp_path / "merged.json"
        n = merge_traces([f"{trace_path}.host{h}" for h in (0, 1)], merged)
        events = load_trace(merged)
        assert n == len(events) > 0
        assert sorted({e["pid"] for e in events}) == [0, 1]


def _launcher_flags(tmp_path, tag):
    return ["--device", "cpu", "--config", "launcher", "--T", 10,
            "--requests", REQUESTS, "--slots", 4, "--clients", 2, "--mix",
            "--num-classes", 2, "--guidance", 1.5, "--ticks-per-dispatch", 2,
            "--async-depth", 2, "--json", tmp_path / f"{tag}.json", "--out",
            tmp_path / f"{tag}.npz"]


def test_serve_diffusion_two_devices_merge_the_one_device_run(tmp_path):
    outs = run_children([
        [sys.executable, "-m", "repro_torch.launch.serve_diffusion",
         *_launcher_flags(tmp_path, tag), "--devices", d, "--mesh-shape",
         f"{d}x1"] for tag, d in (("one", 1), ("two", 2))])
    assert "mesh=data:2xmodel:1" in outs[1] and "serve_diffusion OK" in outs[1]
    one, two = (json.loads((tmp_path / f"{t}.json").read_text())
                for t in ("one", "two"))
    assert [h["host"] for h in two["hosts"]] == [0, 1]
    assert sum(h["halo_lanes"] for h in two["hosts"]) > 0
    assert all(h["repeat_bitwise"] for h in one["hosts"] + two["hosts"])
    assert sum(h["finish_lanes"] for h in two["hosts"]) == \
        one["hosts"][0]["finish_lanes"] == one["images"]
    for key in ("served", "requests", "images", "ticks", "windows",
                "latency_ticks_p50", "latency_ticks_p95",
                "utilization_mean", "server_flops", "client_flops",
                "fragmentation_frac", "occupancy_by_class"):
        assert two[key] == one[key], key
    rows = [np.load(tmp_path / f"{t}.npz") for t in ("one", "two")]
    assert sorted(rows[0].files) == sorted(rows[1].files)
    assert any(f.startswith("x0_") for f in rows[0].files)
    for f in rows[0].files:
        np.testing.assert_array_equal(rows[0][f], rows[1][f], err_msg=f)


def test_serve_diffusion_refuses_a_model_axis(tmp_path):
    """It no longer refuses one: ``--devices 2 --mesh-shape 1x2`` serves
    one host over two model ranks (eager windows, said on the first line),
    its completions the same bits on both ranks and within the model-axis
    serve's CPU bound (``test_torch_unet_mesh.SERVE_TOL``) of the one-device
    run; the summary keeps its form."""
    outs = run_children([
        [sys.executable, "-m", "repro_torch.launch.serve_diffusion",
         *_launcher_flags(tmp_path, tag), "--devices", d, "--mesh-shape",
         f"1x{d}"] for tag, d in (("one", 1), ("two", 2))])
    first = [ln for ln in outs[1].splitlines()
             if ln.startswith("serve_diffusion:")][0]
    assert first.startswith("serve_diffusion: mesh=data:1xmodel:2 "
                            "windows=eager")
    assert "serve_diffusion OK" in outs[1]
    one, two = (json.loads((tmp_path / f"{t}.json").read_text())
                for t in ("one", "two"))
    assert two["mesh"] == "data:1xmodel:2"
    assert two["hosts"][0]["model_bitwise"] is True
    assert two["hosts"][0]["repeat_bitwise"] is True
    assert two["hosts"][0]["collectives"]["calls"] > 0
    for key in ("served", "requests", "images", "ticks", "windows",
                "server_flops", "client_flops"):
        assert two[key] == one[key], key
    rows = [np.load(tmp_path / f"{t}.npz") for t in ("one", "two")]
    assert sorted(rows[0].files) == sorted(rows[1].files)
    for f in rows[0].files:
        np.testing.assert_allclose(rows[1][f], rows[0][f], rtol=0,
                                   atol=1e-3, err_msg=f)
