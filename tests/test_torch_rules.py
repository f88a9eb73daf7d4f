"""Guards for the port's rules: it imports neither jax nor the JAX package,
its entry points raise without CUDA unless the CPU is asked for, and a
kernel wrapper's choice between kernel and plain version follows the
tensor's device alone."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import UNetConfig  # noqa: E402
from repro_torch.diffusion.schedule import cosine_schedule  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n == "repro" or n.startswith("repro."))
print("MODULES", len([n for n in sys.modules if n.startswith("repro_torch")]))
print("NAMES", ",".join(sorted(n for n in sys.modules
                               if n.startswith("repro_torch."))))
print("BAD", bad)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}")
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(ln.split(" ", 1) for ln in proc.stdout.splitlines()
                 if ln.startswith(("MODULES", "NAMES", "BAD")))
    assert int(lines["MODULES"]) >= 20
    assert lines["BAD"] == "[]", lines["BAD"]
    # the checkpoint module and the examples among what was imported
    assert {"repro_torch.checkpoint.io", "repro_torch.core.trainer",
            "repro_torch.examples.collafuse_healthcare",
            "repro_torch.examples.cut_ratio_sweep",
            "repro_torch.examples.quickstart",
            "repro_torch.examples.privacy_admission_sweep"} <= set(
                lines["NAMES"].split(","))


def test_port_sources_name_no_jax_repro_or_environment():
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]:
        for ln in path.read_text().splitlines():
            code = ln.split("#")[0]
            words = code.replace("(", " ").replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "jaxlib",
                                                      "repro"), (path, ln)
            assert "os.environ" not in code and "getenv" not in code, \
                (path, ln)


@pytest.mark.parametrize("layer", ["kernels", "models"])
def test_kernels_and_models_import_nothing_of_the_launchers(layer):
    """The launch layer builds on the models and the kernels, never the
    other way: a work counter reaches a kernel wrapper through
    ``kernels/units.py``."""
    for path in (PKG / layer).rglob("*.py"):
        for ln in path.read_text().splitlines():
            words = ln.split("#")[0].split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith("repro_torch.launch"), \
                    (path, ln)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")


def test_engine_default_device_raises_without_cuda():
    _no_cuda()
    from repro_torch.models.unet import UNet
    from repro_torch.serve import EngineConfig, ServeEngine
    model = UNet(UNetConfig().reduced())
    cfg = EngineConfig(sched=cosine_schedule(10), image_shape=(16, 16, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, model)
    # asked for explicitly, the CPU works
    ServeEngine(EngineConfig(sched=cosine_schedule(10),
                             image_shape=(16, 16, 1), device="cpu"), model)


def test_sampling_entry_points_default_to_cuda():
    _no_cuda()
    from repro_torch.core import collafuse as tcf
    plan = tcf.CutPlan(10, 0.5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcf.split_sample_lane(cosine_schedule(10), plan, None, None, 0, 0,
                              (4, 4, 1))


def test_launcher_default_device_raises_without_cuda():
    _no_cuda()
    from repro_torch.launch import serve_diffusion
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_diffusion.main(["--config", "launcher", "--T", "4",
                              "--requests", "1"])


def test_trainer_and_training_launcher_default_to_cuda():
    _no_cuda()
    from repro_torch.core.trainer import CollaFuseTrainer, TrainerConfig
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch import clients_sweep
    from repro_torch.launch import train as lm_train
    from repro_torch.launch.serve_diffusion import launcher_config
    from repro_torch.models.unet import UNet

    def factory(seed):
        return UNet(launcher_config(8), seed=seed)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CollaFuseTrainer(TrainerConfig(n_clients=2, T=4), factory)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        clients_sweep.main(["--clients", "2", "--rounds", "1", "--T", "4"])
    # the LM training launcher and its data
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_train.main(["--arch", "yi-6b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(token_batches(16, 1, 4))
    # asked for explicitly, the CPU works
    CollaFuseTrainer(TrainerConfig(n_clients=2, T=4), factory, device="cpu")


def test_guards_cover_the_training_modules():
    """The import and source-word guards above walk every module of the
    package: the training slices' (diffusion and LM), the checkpoint
    module and the examples among them."""
    names = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"core/trainer.py", "core/privacy.py", "optim/adamw.py",
            "optim/schedule.py", "launch/train.py",
            "data/synthetic.py", "launch/clients_sweep.py",
            "checkpoint/io.py", "examples/collafuse_healthcare.py",
            "examples/cut_ratio_sweep.py", "examples/quickstart.py",
            "examples/privacy_admission_sweep.py"} <= names


@pytest.mark.parametrize("var,value", [("REPRO_PALLAS_INTERPRET", "0"),
                                       ("REPRO_TORCH_KERNELS", "cuda"),
                                       ("CUDA_VISIBLE_DEVICES", "0")])
def test_cpu_tensors_take_the_plain_version_whatever_the_environment(
        monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    g = torch.Generator().manual_seed(0)
    x, eps, z = (torch.randn((4, 8, 8, 1), generator=g) for _ in range(3))
    cols = torch.tensor([0, 3, -1, 50], dtype=torch.int32)
    active = torch.tensor([True, True, False, False])
    tables = torch.rand((5, 6), generator=g) + 0.1
    coefs = torch.rand((4, 4), generator=g)
    before = ops.launch_counts()
    out = ops.traj_masked_step(x, cols, eps, z, active, tables)
    assert torch.equal(out, kref.traj_masked_step_ref(x, cols, eps, z, active,
                                                     tables))
    out = ops.ddpm_step(x, eps, z, coefs)
    assert torch.equal(out, kref.ddpm_step_ref(x, eps, z, coefs))
    assert ops.launch_counts() == before          # no kernel was launched


def test_non_cpu_tensors_never_take_the_plain_version():
    """On any device but the CPU a wrapper launches its kernel or raises.
    A tensor on the meta device cannot be launched on: the step kernels
    raise; the LM kernels, which the dry run reaches, return the output's
    shape and dtype on meta and launch nothing."""
    x = torch.empty((2, 4, 4, 1), device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        ops.ddpm_step(x, x, x, torch.empty((2, 4), device="meta"))
    with pytest.raises(ValueError, match="runs on CUDA"):
        ops.traj_masked_step(x, torch.empty(2, dtype=torch.int32,
                                            device="meta"), x, x,
                             torch.empty(2, dtype=torch.bool, device="meta"),
                             torch.empty((5, 3), device="meta"))
    ops.reset_launch_counts()
    q = torch.empty((1, 8, 4, 32), device="meta")
    out = ops.flash_attention(q, q, q)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    bm = torch.empty((1, 8, 16), device="meta")
    y = ops.ssm_scan(q, torch.empty((1, 8, 4), device="meta"),
                     torch.empty(4, device="meta"), bm, bm)
    assert y.is_meta and y.shape == q.shape
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="meta and real"):
        ops.flash_attention(q, torch.empty((1, 8, 4, 32)), q)


def test_reset_launch_counts():
    ops.ddpm_step.launches = 3
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"ddpm_step": 0, "traj_masked_step": 0,
                                   "flash_attention": 0, "ssm_scan": 0,
                                   "lane_noise": 0}
