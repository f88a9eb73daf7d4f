"""The port's examples (``repro_torch.examples``) against the reference's
(``examples/``): the same configurations and data, bitwise, and each
example's ``main`` run on the CPU at a small size, closing with the
reference's last line.  No reference round is run: the reference's
``build()`` is called with its trainer stubbed, so no model of either
package is initialised at full width."""
import argparse
import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import trainer as ttr  # noqa: E402
from repro_torch.examples import collafuse_healthcare as hc  # noqa: E402
from repro_torch.examples import cut_ratio_sweep  # noqa: E402
from repro_torch.examples import privacy_admission_sweep  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples import serve_decode  # noqa: E402

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
BACKENDS = {"jnp": "torch", "pallas": "triton", "pallas_masked": "cuda_masked"}


def _reference(name):
    """Import the reference's ``examples/<name>.py`` as a module."""
    sys.path.insert(0, str(EXAMPLES))
    try:
        spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                      EXAMPLES / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(EXAMPLES))
    return mod


class _Stop(Exception):
    """Raised by a stub once it has captured what a test compares."""


def _args(full, backend="jnp", **kw):
    return argparse.Namespace(**{**dict(
        full=full, batch=None, clients=3, cut_ratio=0.8, seed=0,
        per_client=4, holdout=3, step_backend=backend, sampler="ddim",
        num_steps=10, eta=0.5, micro_batch=None, device="cpu"), **kw})


def _assert_same_configs(port_ucfg, port_tcfg, ref_ucfg, ref_tcfg):
    assert dataclasses.asdict(port_ucfg) == dataclasses.asdict(ref_ucfg)
    ref = dataclasses.asdict(ref_tcfg)
    ref["step_backend"] = BACKENDS[ref["step_backend"]]
    assert dataclasses.asdict(port_tcfg) == ref


def _assert_same_data(port, ref):
    (pc, ph), (rc, rh) = port, ref
    assert len(pc) == len(rc)
    for a, b in zip(list(pc) + [ph], list(rc) + [rh]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _stub_trainers(monkeypatch, ref):
    """Stub the reference's trainer and the port's ``_trainer``: each
    records what it was built from; no model is initialised."""
    seen = {}
    monkeypatch.setattr(ref, "CollaFuseTrainer",
                        lambda tcfg, init_fn, apply_fn: seen.setdefault(
                            "ref", (tcfg, init_fn.keywords["cfg"])))
    monkeypatch.setattr(hc, "_trainer",
                        lambda tcfg, ucfg, device, micro_batch:
                        seen.setdefault("port", (tcfg, ucfg, micro_batch)))
    return seen


@pytest.mark.parametrize("full,backend,batch,micro", [
    (False, "jnp", None, None), (False, "pallas_masked", 5, 3),
    (True, "pallas", None, None), (True, "jnp", 7, 5)])
def test_healthcare_build(monkeypatch, full, backend, batch, micro):
    """The default size and ``--full`` (at 2 images a client): the
    reference's U-Net and trainer configurations (the paper's U-Net, T =
    100, batch 150 with ``--full``), its data bitwise, and the chunk
    (``--full``'s default, or the one given)."""
    ref = _reference("collafuse_healthcare")
    seen = _stub_trainers(monkeypatch, ref)
    kw = dict(per_client=2, holdout=2, batch=batch)
    _, rucfg, rclients, rholdout, rbatch = ref.build(_args(full, backend,
                                                           **kw))
    _, ucfg, clients, holdout, pbatch = hc.build(
        _args(full, BACKENDS[backend], micro_batch=micro, **kw))
    tcfg, ucfg_built, used_micro = seen["port"]
    assert ucfg_built is ucfg and rucfg is seen["ref"][1]
    _assert_same_configs(ucfg, tcfg, seen["ref"][1], seen["ref"][0])
    assert (ucfg.image_size, tcfg.T) == ((128, 100) if full else (32, 50))
    assert pbatch == rbatch == (batch or (150 if full else 32))
    assert used_micro == (micro or (hc.FULL_MICRO_BATCH if full else None))
    _assert_same_data((clients, holdout), (rclients, rholdout))


def test_healthcare_build_makes_the_reference_backbone():
    """The trainer build() makes, on the CPU, holds the reference's
    backbone: the same parameter count (the reference's from its shapes)."""
    import jax

    from repro.configs.base import UNetConfig as JaxUNetConfig
    from repro.models import unet as junet
    tr, ucfg, _, _, _ = hc.build(_args(False, "torch", per_client=2,
                                       holdout=2))
    shapes = jax.eval_shape(
        lambda k: junet.init_params(k, JaxUNetConfig(**dataclasses.asdict(
            ucfg))), jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in tr.server_params.values()) == n_ref
    assert tr.device == torch.device("cpu") and tr.micro_batch is None
    assert len(tr.client_params) == 3


def _capture_build(monkeypatch, module):
    """Replace ``module.build`` by a stub that records its args and stops."""
    got = []

    def stub(args):
        got.append(argparse.Namespace(**vars(args)))
        raise _Stop
    monkeypatch.setattr(module, "build", stub)
    return got


def test_cut_ratio_sweep_builds_what_the_reference_builds(monkeypatch):
    ref = _reference("cut_ratio_sweep")
    got_ref = _capture_build(monkeypatch, ref)
    got = _capture_build(monkeypatch, cut_ratio_sweep)
    monkeypatch.setattr(sys, "argv", ["cut_ratio_sweep.py"])
    for main in (ref.main, lambda: cut_ratio_sweep.main(["--device",
                                                          "cpu"])):
        with pytest.raises(_Stop):
            main()
    a, r = vars(got[0]), vars(got_ref[0])
    for k in ("rounds", "clients", "per_client", "holdout", "batch", "seed",
              "full", "sampler", "num_steps", "eta", "cut_ratio"):
        assert a[k] == r[k], k
    assert a["cuts"] == r["cuts"] and a["step_backend"] == "torch"
    # the first cut's build, both packages, bitwise in configs and data
    ref_hc = _reference("collafuse_healthcare")
    seen = _stub_trainers(monkeypatch, ref_hc)
    _, rucfg, rclients, rholdout, rbatch = ref_hc.build(
        argparse.Namespace(**{**r, "per_client": 4, "holdout": 3}))
    _, ucfg, clients, holdout, batch = hc.build(argparse.Namespace(
        **{**a, "per_client": 4, "holdout": 3}))
    _assert_same_configs(ucfg, seen["port"][0], rucfg, seen["ref"][0])
    _assert_same_data((clients, holdout), (rclients, rholdout))
    assert batch == rbatch == 32


def test_quickstart_configs_match_the_reference(monkeypatch):
    ref = _reference("quickstart")
    seen = {}

    def ref_trainer(tcfg, init_fn, apply_fn):
        seen["ref"] = (tcfg, init_fn.keywords["cfg"])
        return argparse.Namespace(plan=argparse.Namespace(
            describe=lambda: ""))

    def ref_data(dcfg):
        seen["ref_data"] = dcfg
        raise _Stop
    monkeypatch.setattr(ref, "CollaFuseTrainer", ref_trainer)
    monkeypatch.setattr(ref, "make_client_datasets", ref_data)
    with pytest.raises(_Stop):
        ref.main()
    real_trainer = quickstart.CollaFuseTrainer

    def port_trainer(tcfg, factory, device):
        seen["port"] = (tcfg, factory(0).cfg)
        return real_trainer(tcfg, factory, device=device)

    def port_data(dcfg):
        seen["port_data"] = dcfg
        raise _Stop
    monkeypatch.setattr(quickstart, "CollaFuseTrainer", port_trainer)
    monkeypatch.setattr(quickstart, "make_client_datasets", port_data)
    with pytest.raises(_Stop):
        quickstart.main(["--device", "cpu"])
    _assert_same_configs(seen["port"][1], seen["port"][0], seen["ref"][1],
                         seen["ref"][0])
    assert dataclasses.asdict(seen["port_data"]) == \
        dataclasses.asdict(seen["ref_data"])


def test_privacy_sweep_configs_match_the_reference(monkeypatch):
    ref = _reference("privacy_admission_sweep")
    seen = {}

    def ref_init(key, cfg):
        seen["ref"] = cfg
        return {"w": np.zeros(1, np.float32)}

    def ref_data(dcfg):
        seen["ref_data"] = dcfg
        raise _Stop
    monkeypatch.setattr(ref.unet, "init_params", ref_init)
    monkeypatch.setattr(ref, "make_client_datasets", ref_data)
    monkeypatch.setattr(sys, "argv", ["privacy_admission_sweep.py"])
    with pytest.raises(_Stop):
        ref.main()
    real_unet = privacy_admission_sweep.UNet

    def port_unet(cfg, seed):
        seen["port"] = cfg
        return real_unet(cfg, seed=seed)

    def port_data(dcfg):
        seen["port_data"] = dcfg
        raise _Stop
    monkeypatch.setattr(privacy_admission_sweep, "UNet", port_unet)
    monkeypatch.setattr(privacy_admission_sweep, "make_client_datasets",
                        port_data)
    with pytest.raises(_Stop):
        privacy_admission_sweep.main(["--device", "cpu"])
    assert dataclasses.asdict(seen["port"]) == dataclasses.asdict(seen["ref"])
    assert dataclasses.asdict(seen["port_data"]) == \
        dataclasses.asdict(seen["ref_data"])


# ---------------------------------------------------------------------------
# each main on the CPU, closing with the reference's last line
# ---------------------------------------------------------------------------
def _last_line(capsys):
    return capsys.readouterr().out.strip().splitlines()[-1]


def test_healthcare_main_and_the_sweep_on_its_checkpoint(tmp_path, capsys):
    out = str(tmp_path / "res")
    ckpt = str(tmp_path / "ck")
    ev = hc.main(["--device", "cpu", "--rounds", "2", "--clients", "2",
                  "--per-client", "4", "--holdout", "3", "--batch", "2",
                  "--n-gen", "2",
                  "--micro-batch", "2", "--out-dir", out, "--save", ckpt])
    path = tmp_path / "res" / "healthcare" / "c0.8.json"
    assert _last_line(capsys) == f"wrote {path}"
    assert path.exists() and ev["rounds"] == 2
    assert all(np.isfinite(ev[k]) for k in ("kid_train_sum",
                                            "kid_holdout_sum",
                                            "disclosure_mse_mean"))
    tr, ucfg = hc.load_trained(ckpt, "cpu")
    assert tr.round == 2 and tr.micro_batch == 2 and ucfg.image_size == 32
    rows = privacy_admission_sweep.main(
        ["--device", "cpu", "--ckpt", ckpt + ".npz", "--calib", "2",
         "--requests", "3", "--num-steps", "3", "--slots", "2",
         "--floors", "-10", "10", "--out-dir", out])
    assert _last_line(capsys) == "privacy_admission_sweep OK"
    assert [r["served"] for r in rows] == [3, 0]


def test_privacy_sweep_main(tmp_path, capsys):
    rows = privacy_admission_sweep.main(["--device", "cpu", "--out-dir",
                                         str(tmp_path)])
    assert _last_line(capsys) == "privacy_admission_sweep OK"
    assert rows[0]["served"] == 9 and rows[-1]["served"] == 0
    assert (tmp_path / "privacy_admission_sweep.json").exists()


def test_cut_ratio_sweep_main(tmp_path, capsys):
    rows = cut_ratio_sweep.main(
        ["--device", "cpu", "--rounds", "1", "--cuts", "0.8", "1.0",
         "--clients", "2", "--per-client", "2", "--holdout", "2", "--batch", "2", "--n-gen",
         "2", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "H2c client FLOP share monotone in c -> SUPPORTED"
    assert out[-2].startswith("H1  collaborative best")
    assert [r["client_flop_fraction"] for r in rows][-1] == 1.0
    assert (tmp_path / "cut_ratio_sweep.json").exists()


def test_quickstart_main(capsys):
    rep = quickstart.main(["--device", "cpu", "--rounds", "1"])
    last = _last_line(capsys)
    assert last.startswith("disclosure at t_split: mse=")
    assert last.endswith("(higher = more concealed)")
    assert np.isfinite(rep["mse"]) and np.isfinite(rep["kid"])


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    for main in (hc.main, cut_ratio_sweep.main, quickstart.main,
                 privacy_admission_sweep.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--rounds", "1"] if main is not privacy_admission_sweep.main
                 else [])
    assert ttr.CollaFuseTrainer.__init__.__defaults__[0] == "cuda"


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-7b", "deepseek-v2-236b",
                                  "kimi-k2-1t-a32b"])
def test_serve_decode_main(arch, capsys):
    """The reduced member served at a few tokens: the reference's lines,
    its parameter count (the reference's tree), finite logits, ids in the
    vocabulary."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtf
    cfg = jget_config(arch).reduced()
    shapes = jax.eval_shape(lambda k: jtf.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    out = serve_decode.main(["--device", "cpu", "--arch", arch, "--batch",
                             "2", "--prompt-len", "5", "--tokens", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == (f"{arch} (reduced): {n/1e6:.1f}M params, "
                        f"family={cfg.family}")
    assert lines[1].startswith("prefill 2x5: ")
    assert lines[2].startswith("decoded 4 tokens x 2 seqs in ")
    assert lines[3] == f"sample token ids: {out[0].tolist()}"
    assert lines[-1] == "OK"
    assert out.shape == (2, 4) and int(out.max()) < cfg.vocab_size
    again = serve_decode.main(["--device", "cpu", "--arch", arch, "--batch",
                               "2", "--prompt-len", "5", "--tokens", "4"])
    assert torch.equal(out, again)                 # seeded


def test_serve_decode_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_decode.main([])
