"""Port parity for the LM training launcher's parts: ``token_batches``
bitwise the reference's, the LR schedules against ``repro/optim/
schedule.py``, the launcher on the CPU at ``reduced()`` with its
``--ckpt``/``--resume`` round trip, and what it refuses."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import set_torch_cpu  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro_torch.checkpoint import io as ckpt_io  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import token_batches  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.steps import make_ctx  # noqa: E402
from repro_torch.optim import schedule as tschedule  # noqa: E402

set_torch_cpu()


@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 4, 32, 0),
                                                  (122_753, 2, 64, 7)])
def test_token_batches_are_the_references(structured, vocab, batch, seq,
                                          seed):
    """The same values for the same seed, batch after batch (the numpy
    draws in the reference's order), as int64 on the device asked for;
    labels are the tokens shifted by one."""
    ref = jsynthetic.token_batches(vocab, batch, seq, seed, structured)
    got = token_batches(vocab, batch, seq, seed, structured, device="cpu")
    for _ in range(3):
        r, g = next(ref), next(got)
        for key in ("tokens", "labels"):
            assert g[key].dtype == torch.int64
            assert g[key].shape == (batch, seq)
            assert g[key].device.type == "cpu"
            assert np.array_equal(g[key].numpy(),
                                  np.asarray(r[key]).astype(np.int64))
        assert torch.equal(g["tokens"][:, 1:], g["labels"][:, :-1])


SCHEDULES = [("constant", 10, {}), ("cosine", 50, {}),
             ("cosine", 100, dict(warmup=10, final_frac=0.0)),
             ("cosine", 7, dict(warmup=3)), ("wsd", 20, {}),
             ("wsd", 1000, {}),
             ("wsd", 60, dict(warmup_frac=0.1, decay_frac=0.3,
                              final_frac=0.05))]


@pytest.mark.parametrize("name,total,kw", SCHEDULES)
def test_schedules_match_the_reference(name, total, kw):
    """Every step from 0 past the horizon: float32 scalars on the step's
    device.  ``constant`` and ``wsd`` are the reference's bits; ``cosine``
    is its bits through the warmup (cos 0 = 1 in both), and after it within
    2^-23 (one float32 ulp of 1.0): the two libraries' float32 ``cos``
    round apart by an ulp at some arguments, which ``1 + cos`` keeps as an
    absolute error where it cancels near the horizon (measured: 3.0e-8 at
    most, at step 98 of 100 with ``final_frac`` 0)."""
    ref = jschedule.get_schedule(name, total, **kw)
    fn = tschedule.get_schedule(name, total, **kw)
    steps = np.arange(total + 5, dtype=np.int32)
    want = np.array([np.asarray(ref(jnp.asarray(s))) for s in steps],
                    np.float32)
    got = np.array([float(fn(torch.tensor(s))) for s in steps], np.float32)
    out = fn(torch.tensor(3, dtype=torch.int32))
    assert out.dtype == torch.float32 and out.shape == ()
    if name == "cosine":
        warm = steps <= kw.get("warmup", 0)
        assert np.array_equal(got[warm], want[warm])
        assert float(np.abs(got - want).max()) <= 2.0 ** -23
    else:
        assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        tschedule.get_schedule("linear", total)


def test_wsd_shape():
    """MiniCPM's WSD: a linear warmup to the peak, a plateau, a linear decay
    to ``final_frac`` at the horizon and after it."""
    fn = tschedule.wsd(100, warmup_frac=0.05, decay_frac=0.2, final_frac=0.1)
    v = [float(fn(torch.tensor(s, dtype=torch.int32))) for s in range(110)]
    assert v[0] == 0.0 and v[5] == 1.0 and v[80] == 1.0
    assert all(a <= b for a, b in zip(v[:6], v[1:6]))
    assert all(a >= b for a, b in zip(v[80:100], v[81:101]))
    assert v[100] == pytest.approx(0.1) and v[109] == pytest.approx(0.1)


def _run(capsys, *extra):
    out = train.main(["--device", "cpu", "--arch", "yi-6b", "--reduced",
                      "--batch", "8", "--seq", "32", "--lr", "3e-3",
                      *extra])
    return out, capsys.readouterr().out


def _state(out):
    return {**{k: v.detach().clone()
               for k, v in out["model"].named_parameters()},
            **{f"{m}/{k}": v.clone() for m in ("mu", "nu")
               for k, v in out["opt"][m].items()},
            "step": out["opt"]["step"].clone()}


def test_launcher_trains_on_cpu_and_round_trips_its_checkpoint(
        tmp_path, capsys, monkeypatch):
    """6 steps saved, then resumed for 6 more: the restored parameters and
    AdamW state are bitwise the saved ones, and the resumed run ends
    bitwise where one run of 12 steps does."""
    path = str(tmp_path / "lm.npz")
    out, text = _run(capsys, "--steps", "6", "--log-every", "2",
                     "--ckpt", path)
    assert "arch=yi-6b reduced=True mesh=data:1xmodel:1 fsdp=False" in text
    assert "params: " in text and "starting 6 steps" in text
    assert text.count("step ") == 4           # steps 0, 2, 4 and the last
    assert "done: loss" in text and f"saved {path}" in text
    assert out["losses"][-1] < out["losses"][0]
    assert ckpt_io.checkpoint_step(path) == 6
    saved = _state(out)
    restored = []
    orig = train.restore_state

    def spy(p, model, opt):
        tree = orig(p, model, opt)
        restored.append(_state({"model": model, "opt": opt}))
        return tree
    monkeypatch.setattr(train, "restore_state", spy)
    resumed, text = _run(capsys, "--steps", "6", "--resume", path)
    assert f"from {path} (step 6)" in text and "done: loss" in text
    assert set(restored[0]) == set(saved)
    for k in saved:
        assert restored[0][k].dtype == saved[k].dtype
        assert torch.equal(restored[0][k], saved[k]), k
    straight, _ = _run(capsys, "--steps", "12")
    a, b = _state(resumed), _state(straight)
    assert int(a["step"]) == 12
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_launcher_remat_is_bitwise_its_plain_run(capsys):
    plain, _ = _run(capsys, "--steps", "3")
    remat, text = _run(capsys, "--steps", "3", "--remat")
    assert "done: loss" in text
    a, b = _state(plain), _state(remat)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("flags", [["--devices", "2"],
                                   ["--mesh-shape", "2x1"],
                                   ["--mesh-shape", "1x2"], ["--fsdp"]])
def test_launcher_refuses_more_than_one_card(flags, capfd):
    """The flags that one card refused now run: two ranks on the data or
    the model axis (gloo processes, rank 0 prints), and FSDP on one
    device."""
    train.main(["--device", "cpu", "--arch", "yi-6b", "--reduced",
                "--steps", "2", "--log-every", "1", "--batch", "4", "--seq",
                "16", "--lr", "3e-3", *flags])
    out = capfd.readouterr().out
    assert "done: loss" in out
    if flags[0] != "--fsdp":
        d, m = (2, 1) if flags[-1] in ("2", "2x1") else (1, 2)
        assert f"mesh=data:{d}xmodel:{m} transport=gloo" in out


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m"])
def test_launcher_refuses_a_model_axis_for_recurrent_families(arch, capfd):
    """They no longer refuse one: both launchers run the recurrent
    families on a 1x2 mesh (their heads a rank, gloo processes, rank 0
    prints)."""
    from repro_torch.launch import serve
    train.main(["--device", "cpu", "--arch", arch, "--reduced",
                "--devices", "2", "--mesh-shape", "1x2", "--steps", "2",
                "--log-every", "1", "--batch", "2", "--seq", "16", "--lr",
                "3e-3"])
    serve.main(["--device", "cpu", "--arch", arch, "--devices", "2",
                "--mesh-shape", "1x2", "--requests", "1", "--batch", "2",
                "--prompt-len", "8", "--tokens", "2"])
    out = capfd.readouterr().out
    assert "done: loss" in out and "serving loop OK" in out
    assert out.count("mesh=data:1xmodel:2 transport=gloo") == 2


def test_launcher_takes_one_device_spelled_out(capsys):
    train.main(["--device", "cpu", "--arch", "minicpm-2b", "--reduced",
                "--devices", "1", "--mesh-shape", "1x1", "--steps", "2",
                "--log-every", "1", "--batch", "2", "--seq", "16"])
    assert "done: loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large"])
def test_launcher_refuses_vlm_and_audio(arch):
    with pytest.raises(ValueError, match="tokens and labels only"):
        train.main(["--device", "cpu", "--arch", arch, "--reduced"])


def test_launcher_memory_guard(monkeypatch):
    """Parameters, gradients and both float32 moments are counted and
    refused before anything is allocated: Yi-6B's 72.7 GB at full size
    exceed the CPU limit (64 GiB); MiniCPM-2B's 32.7 GB do not."""
    yi, mini = get_config("yi-6b"), get_config("minicpm-2b")
    assert train.train_state_bytes(yi) == yi.param_count() * 12
    assert train.train_state_bytes(mini) == 2_724_880_896 * 12
    assert train.train_state_bytes(yi.reduced()) == \
        yi.reduced().param_count() * 16             # float32 parameters
    cpu = torch.device("cpu")
    assert train.check_state_fits(mini, cpu) == 2_724_880_896 * 12
    need = yi.param_count() * 12
    with pytest.raises(ValueError, match=f"{need} bytes of training state"):
        train.main(["--device", "cpu", "--arch", "yi-6b"])
    glm = get_config("glm4-9b")
    ctx = make_ctx(make_mesh((2, 1), ("data", "model")))
    assert train.train_state_bytes(glm, ctx, fsdp=True) == \
        glm.param_count() * 12 // 2                  # FSDP halves it
    assert train.train_state_bytes(glm, ctx) == glm.param_count() * 12
    monkeypatch.setattr(train, "CPU_STATE_BYTES", 1 << 20)
    small = dataclasses.replace(yi.reduced(), n_layers=8)
    with pytest.raises(ValueError, match="shard it over more cards"):
        train.check_state_fits(small, cpu)


@pytest.mark.parametrize("flags", [
    ["--arch", "deepseek-v2-236b", "--devices", "2", "--mesh-shape", "1x2"],
    ["--arch", "yi-6b", "--devices", "4", "--mesh-shape", "2x2",
     "--cache-seq-shard"]])
def test_serve_launcher_on_a_mesh(flags, capfd):
    """The serving launcher's ranks on the CPU: tensor and expert
    parallelism over ``model``, the rows over ``data``, the cache's
    sequence over ``model``."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "1", "--batch", "2",
                "--prompt-len", "8", "--tokens", "3", *flags])
    out = capfd.readouterr().out
    d, m = flags[flags.index("--mesh-shape") + 1].split("x")
    assert f"mesh=data:{d}xmodel:{m} transport=gloo" in out
    assert "serving loop OK" in out


def test_serve_weight_guard_counts_a_ranks_shard():
    """On 1x8 each rank holds its slice of DeepSeek-V2: the sharded leaves
    (experts, heads, vocabulary, MLP columns) an eighth, the replicated
    ones (router, norms, MLA's down projections) whole."""
    from repro_torch.launch import serve
    cfg = get_config("deepseek-v2-236b")
    one = serve.check_weights_fit(cfg.reduced(), torch.device("cpu"))
    ctx = make_ctx(make_mesh((1, 8), ("data", "model")))
    full = cfg.param_count()
    local = train.local_params(cfg, ctx)
    assert full / 8 < local < full / 7
    assert one == cfg.reduced().param_count() * 4



def test_launcher_resumes_a_one_card_checkpoint_on_a_mesh(tmp_path, capfd):
    """A one-device run's checkpoint resumed on a 2x1 mesh with FSDP: each
    rank cuts its slices from the one-card leaves, trains on, and rank 0
    writes the gathered state in the one-card format again."""
    first, second = str(tmp_path / "one.npz"), str(tmp_path / "mesh.npz")
    _run(capfd, "--steps", "4", "--ckpt", first)
    train.main(["--device", "cpu", "--arch", "yi-6b", "--reduced",
                "--batch", "8", "--seq", "32", "--lr", "3e-3", "--steps",
                "3", "--devices", "2", "--mesh-shape", "2x1", "--fsdp",
                "--resume", first, "--ckpt", second])
    out = capfd.readouterr().out
    assert f"from {first} (step 4)" in out and "done: loss" in out
    assert ckpt_io.checkpoint_step(second) == 7
    tree = ckpt_io.restore_checkpoint(second, _like())
    assert int(tree["opt"]["step"]) == 7


def _like():
    """A one-device model's {params, opt} tree to restore a checkpoint
    into."""
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    cfg = get_config("yi-6b").reduced()
    model = tf.Transformer(cfg, device="cpu")
    params = dict(model.named_parameters())
    return {"params": params,
            "opt": adamw.init_state(params, adamw.AdamWConfig())}
