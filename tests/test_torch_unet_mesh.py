"""The U-Net's model axis (``serve_diffusion``'s ``--mesh-shape DxM``, M
> 1) on a 1x2 world of gloo processes on the CPU.

A module fixture writes two U-Nets' weights (drawn for the reference with
numpy) and inputs, starts the world (``tests/_torch_unet_mesh_worker.py``,
a process a rank, one thread each) and waits.  Each rank holds its block
of every convolution's output channels and gathers them, so:

* the sharded forward at ``UNetConfig().reduced()`` (attention at 8) and
  at the launcher's conditional config agrees with the reference's
  ``unet.forward`` on the same weights (``test_torch_unet.py``'s
  tolerance);
* a serve of the launcher's conditional U-Net gives the same bits on both
  model ranks, keeps the reference's anchors inside the model-axis serve
  (k = 4 ≡ k = 1, stream ≡ drain, pack on ≡ off, w = 0 twins ≡ unguided,
  all bitwise), and agrees with the one-process serve to :data:`SERVE_TOL`.

In process: the port's specs equal the reference's ``param_specs`` leaf
for leaf, and an engine on a model axis refuses CUDA graphs."""
import dataclasses
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import set_torch_cpu, unet_params  # noqa: E402
from _torch_unet_mesh_worker import VARIANTS, serve  # noqa: E402
from repro.configs.base import UNetConfig as JaxUNetConfig  # noqa: E402
from repro.models import unet as junet  # noqa: E402
from repro.models.layers import ShardCtx as JShardCtx  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro_torch.configs import UNetConfig  # noqa: E402
from repro_torch.diffusion.schedule import cosine_schedule  # noqa: E402
from repro_torch.launch.serve_diffusion import launcher_config  # noqa: E402
from repro_torch.launch.steps import make_ctx  # noqa: E402
from repro_torch.models import unet as tunet  # noqa: E402
from repro_torch.parallel.comm import Mesh  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402

set_torch_cpu()

REPO = Path(__file__).resolve().parents[1]
# the one-process serve against the model-axis serve: a convolution of half
# the output channels sums in another order on the CPU (1e-4 seen on the
# launcher's 10-step chains, whose steps divide by sqrt(1 - beta_t))
SERVE_TOL = dict(rtol=0, atol=1e-3)


@dataclasses.dataclass(frozen=True)
class StandIn:
    """All the reference's spec rules read of a mesh: its axis sizes."""
    shape: dict


def _configs():
    """name -> (port config, reference config)."""
    out = {}
    for name, port in (("reduced", UNetConfig().reduced()),
                       ("launcher_cond", launcher_config(8, 3))):
        ref = JaxUNetConfig(**{f.name: getattr(port, f.name)
                               for f in dataclasses.fields(JaxUNetConfig)})
        out[name] = (port, ref)
    return out


def _inputs(port):
    rng = np.random.default_rng(3)
    s = port.image_size
    x = rng.standard_normal((3, s, s, 1)).astype(np.float32)
    t = np.array([1, 37, 100], np.int64)
    y = np.array([0, 2, 9], np.int64) if port.num_classes else None
    return x, t, y


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 1x2 world; returns (each rank's outputs, the reference
    forwards)."""
    root = tmp_path_factory.mktemp("unet_mesh")
    cases = {}
    for name, (port, ref) in _configs().items():
        x, t, y = _inputs(port)
        case = {"cfg": port, "state": tunet.params_from_jax(
            unet_params(ref, 7)), "x": torch.from_numpy(x),
            "t": torch.from_numpy(t)}
        if y is not None:
            case["y"] = torch.from_numpy(y)
        cases[name] = case
    torch.save(cases, root / "forward.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_unet_mesh_worker.py"),
         "--dims", "1x2", "--rank", str(r), "--port", str(port), "--dir",
         str(root)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True) for r in range(2)]
    refs = {}
    for name, (port_cfg, ref) in _configs().items():
        x, t, y = _inputs(port_cfg)
        refs[name] = np.asarray(junet.forward(
            unet_params(ref, 7), jnp.asarray(x), jnp.asarray(t), ref,
            None if y is None else jnp.asarray(y)))
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
    assert err is None, err
    return [np.load(root / f"rank{r}.npz") for r in range(2)], refs


@pytest.mark.parametrize("name", ["reduced", "launcher_cond"])
def test_sharded_unet_forward_matches_reference(world, name):
    ranks, refs = world
    for out in ranks:
        assert int(out[f"sharded.{name}"]) > 0
        np.testing.assert_allclose(out[f"forward.{name}"], refs[name],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ranks[0][f"forward.{name}"],
                                  ranks[1][f"forward.{name}"])


def _variant(out, variant):
    pre = variant + "."
    return {k[len(pre):]: out[k] for k in out.files if k.startswith(pre)}


def test_model_axis_serve_is_bitwise_across_model_ranks(world):
    ranks, _ = world
    assert int(ranks[0]["collective_calls"]) > 0
    for variant in VARIANTS:
        a, b = (_variant(r, variant) for r in ranks)
        assert a and sorted(a) == sorted(b), variant
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=variant + k)


@pytest.mark.parametrize("variant", ["k4", "drain", "pack", "w0"])
def test_model_axis_serve_keeps_the_anchors(world, variant):
    """k = 4 ≡ k = 1, stream ≡ drain, pack on ≡ off and the w = 0 twins ≡
    the unguided requests, bit for bit, inside a model-axis serve."""
    ranks, _ = world
    base, got = _variant(ranks[0], "base"), _variant(ranks[0], variant)
    assert sorted(base) == sorted(got)
    for k in base:
        np.testing.assert_array_equal(got[k], base[k], err_msg=k)


def test_model_axis_serve_matches_one_process(world):
    ranks, _ = world
    one = serve("base")
    got = _variant(ranks[0], "base")
    assert len(got) == 2 * len(one.completions)
    for rid, c in one.completions.items():
        np.testing.assert_allclose(got[f"x_mid.{rid}"], c.x_mid, **SERVE_TOL)
        np.testing.assert_allclose(got[f"x0.{rid}"], c.x0, **SERVE_TOL)


@pytest.mark.parametrize("config", ["paper", "reduced", "launcher_cond"])
def test_unet_specs_match_reference_param_specs(config):
    """The port's per-leaf specs (computed on the reference's names and
    shapes, moved to OIHW) against the reference's ``param_specs`` of its
    ``init_params`` tree on a 1x2 and a 2x4 mesh shape, leaf for leaf."""
    port = {"paper": UNetConfig()}.get(config) or _configs()[config][0]
    ref_cfg = JaxUNetConfig(**{f.name: getattr(port, f.name)
                               for f in dataclasses.fields(JaxUNetConfig)})
    tree = jax.eval_shape(lambda k: junet.init_params(k, ref_cfg),
                          jax.random.PRNGKey(0))
    model = tunet.UNet(port)
    leaves = tunet.reference_leaves(model)
    assert sorted(leaves) == sorted(n for n, _ in model.named_parameters())
    for shape in ((1, 2), (2, 4)):
        jctx = JShardCtx(mesh=StandIn(dict(zip(("data", "model"), shape))))
        flat = jax.tree_util.tree_flatten_with_path(
            jshd.param_specs(tree, jctx),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
        want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): tuple(spec)
                for path, spec in flat}
        got = tunet.param_specs(model, make_ctx(Mesh.abstract(
            dict(zip(("data", "model"), shape)))))
        assert len(want) == len(got)
        for n, (ref_name, ref_shape, perm) in leaves.items():
            w = want[ref_name] + (None,) * (len(perm) - len(want[ref_name]))
            assert got[n] == tuple(w[d] for d in perm), n
        sharded = [n for n, s in got.items() if any(s)]
        assert sharded and all(n.endswith("weight") for n in sharded)
        assert not any(got["conv_out.weight"])


def test_engine_refuses_cuda_graphs_on_a_model_axis():
    """A server U-Net cut over a model axis (a rank's slices; cutting runs
    no collective) with CUDA graphs on raises; eager windows take it."""
    mesh = Mesh(shape={"data": 1, "model": 2},
                coords={"data": 0, "model": 1}, device=torch.device("cpu"))
    server = tunet.shard_unet(tunet.UNet(launcher_config(8)).eval(),
                              make_ctx(mesh))
    kw = dict(sched=cosine_schedule(10), image_shape=(8, 8, 1), slots=4,
              device="cpu")
    with pytest.raises(ValueError, match="CUDA graph cannot hold"):
        ServeEngine(EngineConfig(**kw), server)
    ServeEngine(EngineConfig(**kw, cuda_graphs=False), server)
