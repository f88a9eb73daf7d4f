"""The port's checkpoint module (``repro_torch.checkpoint.io``) and the
trainer's save/restore: round-trips bitwise, the metadata, the faults, and
the file format across the two packages (each reads the other's files and
steps, leaf for leaf bitwise)."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import unet_params  # noqa: E402
from repro.checkpoint import io as jio  # noqa: E402
from repro.configs.base import UNetConfig as JaxUNetConfig  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs import UNetConfig  # noqa: E402
from repro_torch.core import trainer as ttr  # noqa: E402
from repro_torch.data.synthetic import (ClientDataConfig,  # noqa: E402
                                        make_client_datasets)
from repro_torch.models.unet import UNet  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(2)


def _unet_state(seed=0):
    return {k: v.detach().clone() for k, v in
            UNet(UNetConfig().reduced(), seed=seed).named_parameters()}


def _zeros_like(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    return torch.zeros_like(tree)


def _assert_equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal_trees(x, y)
    else:
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def _adam_state(params, steps=2, stacked=False):
    cfg = adamw.AdamWConfig()
    init = adamw.init_stacked_state if stacked else adamw.init_state
    apply = adamw.apply_updates_stacked if stacked else adamw.apply_updates
    state = init(params, cfg)
    g = torch.Generator().manual_seed(3)
    for _ in range(steps):
        grads = {k: torch.randn(v.shape, generator=g)
                 for k, v in params.items()}
        params, state, _ = apply(params, grads, state, cfg)
    return params, state


def test_unet_state_round_trips_bitwise(tmp_path):
    state = _unet_state()
    tio.save_checkpoint(str(tmp_path / "unet"), state, step=3)
    back = tio.restore_checkpoint(str(tmp_path / "unet"), _zeros_like(state))
    _assert_equal_trees(back, state)


def test_adamw_state_round_trips_bitwise(tmp_path):
    params, state = _adam_state(_unet_state())
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 2
    tree = {"params": params, "opt": state}
    tio.save_checkpoint(str(tmp_path / "opt.npz"), tree, step=2)
    _assert_equal_trees(tio.restore_checkpoint(str(tmp_path / "opt.npz"),
                                               _zeros_like(tree)), tree)


def test_stacked_client_state_round_trips_bitwise(tmp_path):
    stack = adamw.tree_stack([_unet_state(s) for s in range(3)])
    stack, state = _adam_state(stack, stacked=True)
    assert state["step"].shape == (3,)
    tree = {"clients": {"params": stack, "opt": state}, "ids": [
        torch.arange(3, dtype=torch.int64), (torch.tensor(True),)]}
    tio.save_checkpoint(str(tmp_path / "stack"), tree)
    _assert_equal_trees(tio.restore_checkpoint(str(tmp_path / "stack"),
                                               _zeros_like(tree)), tree)
    assert tio.checkpoint_step(str(tmp_path / "stack")) is None


def test_meta_keys_and_bfloat16(tmp_path):
    x = torch.randn(4, 3).to(torch.bfloat16)
    tree = {"b": {"z": x, "a": torch.ones(2)}, "l": [torch.zeros(1)]}
    tio.save_checkpoint(str(tmp_path / "m"), tree, step=11)
    with np.load(tmp_path / "m.npz", allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        assert data["b/z"].dtype == np.uint16
    assert meta["step"] == 11
    assert meta["keys"] == ["b/a", "b/z", "l/0"]       # dict keys sorted
    assert meta["dtypes"]["b/z"] == "bfloat16"
    assert json.loads(meta["treedef"]) == {"b": {"a": "*", "z": "*"},
                                           "l": ["*"]}
    back = tio.restore_checkpoint(str(tmp_path / "m"), _zeros_like(tree))
    assert back["b"]["z"].dtype == torch.bfloat16
    assert torch.equal(back["b"]["z"], x)               # bitwise
    # restored at the like leaf's dtype
    like = {"b": {"z": torch.zeros(4, 3), "a": torch.zeros(2)},
            "l": [torch.zeros(1)]}
    assert torch.equal(tio.restore_checkpoint(str(tmp_path / "m"),
                                              like)["b"]["z"], x.float())


def test_checkpoint_step_suffix_and_missing_leaf(tmp_path):
    assert tio.checkpoint_step(str(tmp_path / "absent")) is None
    assert tio.checkpoint_step(str(tmp_path / "absent.npz")) is None
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    tio.save_checkpoint(str(tmp_path / "sub" / "ck.npz"), tree, step=4)
    assert (tmp_path / "sub" / "ck.npz").exists()
    assert not (tmp_path / "sub" / "ck.npz.npz").exists()
    for p in ("ck", "ck.npz"):
        assert tio.checkpoint_step(str(tmp_path / "sub" / p)) == 4
        _assert_equal_trees(tio.restore_checkpoint(
            str(tmp_path / "sub" / p), _zeros_like(tree)), tree)
    with pytest.raises(KeyError, match="'v'"):
        tio.restore_checkpoint(str(tmp_path / "sub" / "ck"),
                               {"w": torch.zeros(2, 3), "v": torch.zeros(1)})


# ---------------------------------------------------------------------------
# the trainer's whole state
# ---------------------------------------------------------------------------
def _trainer(batched=True):
    ucfg = UNetConfig().reduced()
    return ttr.CollaFuseTrainer(
        ttr.TrainerConfig(n_clients=3, T=10, batched=batched),
        lambda s: UNet(ucfg, seed=s % 9973), device="cpu")


def _data():
    clients, _ = make_client_datasets(ClientDataConfig(
        n_clients=3, per_client=2, image_size=16, holdout=2))
    return clients


@pytest.mark.parametrize("batched", [True, False])
def test_trainer_save_and_restore(tmp_path, batched):
    """A trained trainer restored into a fresh one (of either engine) reads
    bitwise the saved state and round counter, and its next round is the
    original's next round, bit for bit."""
    tr = _trainer(batched)
    tr.train_round(_data())
    tr.save(str(tmp_path / "tr"))
    assert tio.checkpoint_step(str(tmp_path / "tr")) == 1
    for fresh_batched in (batched, not batched):
        fresh = _trainer(fresh_batched)
        fresh.restore(str(tmp_path / "tr.npz"))
        assert fresh.round == 1
        _assert_equal_trees(fresh.state_tree(), tr.state_tree())
        for k in range(3):
            _assert_equal_trees(fresh.client_params[k], tr.client_params[k])
    fresh = _trainer(batched)
    fresh.restore(str(tmp_path / "tr"))
    m, fm = tr.train_round(_data()), fresh.train_round(_data())
    assert m["server_loss"] == fm["server_loss"]
    assert m["client_losses"] == fm["client_losses"]
    _assert_equal_trees(fresh.state_tree(), tr.state_tree())


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def test_the_reference_reads_the_ports_file(tmp_path):
    params, state = _adam_state(_unet_state())
    tree = {"server": {"params": params, "opt": state},
            "labels": [torch.arange(4, dtype=torch.int32)]}
    tio.save_checkpoint(str(tmp_path / "port"), tree, step=9)
    like = _np_tree({"server": {"params": {k: v.numpy() for k, v in
                                           params.items()},
                                "opt": {"step": state["step"].numpy(),
                                        "mu": {k: v.numpy() for k, v in
                                               state["mu"].items()},
                                        "nu": {k: v.numpy() for k, v in
                                               state["nu"].items()}}},
                     "labels": [np.zeros(4, np.int32)]})
    back = jio.restore_checkpoint(str(tmp_path / "port"), like)
    assert jio.checkpoint_step(str(tmp_path / "port")) == 9
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(back["server"]["params"][k]),
                                      v.numpy())
        assert np.asarray(back["server"]["params"][k]).dtype == np.float32
    for k, v in state["nu"].items():
        np.testing.assert_array_equal(
            np.asarray(back["server"]["opt"]["nu"][k]), v.numpy())
    assert int(back["server"]["opt"]["step"]) == 2
    np.testing.assert_array_equal(np.asarray(back["labels"][0]),
                                  np.arange(4, dtype=np.int32))


def test_the_port_reads_the_references_file(tmp_path):
    ref = unet_params(JaxUNetConfig().reduced(), 0)
    tree = {"params": ref, "step": jnp.asarray(5, jnp.int32),
            "mask": jnp.asarray([True, False])}
    jio.save_checkpoint(str(tmp_path / "ref"), tree, step=5)
    assert tio.checkpoint_step(str(tmp_path / "ref")) == 5
    like = _zeros_like(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree))
    back = tio.restore_checkpoint(str(tmp_path / "ref.npz"), like)
    flat_ref = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_ref) == len(tio._flatten(back))
    for path, leaf in flat_ref:
        node = back
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        assert node.dtype == torch.from_numpy(np.array(leaf)).dtype
        assert torch.equal(node, torch.from_numpy(np.array(leaf)))
