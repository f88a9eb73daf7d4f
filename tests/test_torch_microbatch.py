"""The trainer's ``micro_batch``: a step's batch run in chunks, the
chunks' weighted gradients summed before one AdamW update.  Chunked
against unchunked on the same draws, both engines, with and without
labels, at ``UNetConfig().reduced()`` and 5 images a client.

Tolerances: the chunked loss is a sum of chunk means weighted by their
shares, the unchunked one a single mean, so the losses of round 0 (the
same parameters) agree to f32 rounding: rtol 1e-6 (measured ~1e-7).  The
parameters after two AdamW steps are held to the bound
``tests/test_torch_train.py`` holds the port to the reference with: Adam's
first steps move a parameter by about ±lr by its gradient's sign, so a
gradient near 0 can end up either side of it (every entry within
2·1.001·lr·rounds, the mean |Δ| within 1e-3·lr).  Round 1's losses run on
those parameters: rtol 1e-5.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import UNetConfig  # noqa: E402
from repro_torch.core import trainer as ttr  # noqa: E402
from repro_torch.data.synthetic import (ClientDataConfig,  # noqa: E402
                                        make_client_datasets)
from repro_torch.models.unet import UNet  # noqa: E402

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(2)

T, N_CLIENTS, B, ROUNDS = 10, 3, 5, 2
NUM_CLASSES, LABEL_DROP = 3, 0.3
LABELS = [torch.tensor(v) for v in ([0, 1, 2, 1, 3], [2, 2, 0, 1, 0],
                                    [1, 0, 3, 2, 2])]   # 3 = the null row
LOSS_RTOL = {0: 1e-6, 1: 1e-5}                           # by round
PARAM_MAX = 2 * 1.001 * 1e-3 * ROUNDS
PARAM_MEAN = 1e-6


def _ucfg(labeled):
    return dataclasses.replace(UNetConfig().reduced(),
                               num_classes=NUM_CLASSES if labeled else 0)


def _trainer(batched, labeled, **kw):
    ucfg = _ucfg(labeled)
    cfg = ttr.TrainerConfig(n_clients=N_CLIENTS, T=T, cut_ratio=0.8,
                            batched=batched,
                            num_classes=NUM_CLASSES if labeled else 0,
                            label_drop=LABEL_DROP)
    return ttr.CollaFuseTrainer(cfg, lambda s: UNet(ucfg, seed=s % 9973),
                                device="cpu", **kw)


def _data(sizes=(B,) * N_CLIENTS):
    clients, _ = make_client_datasets(ClientDataConfig(
        n_clients=N_CLIENTS, per_client=max(sizes), image_size=16,
        holdout=2))
    return [c[:n] for c, n in zip(clients, sizes)]


def _train(tr, labeled, rounds=ROUNDS, sizes=(B,) * N_CLIENTS):
    data = _data(sizes)
    labels = ([y[:n] for y, n in zip(LABELS, sizes)] if labeled else None)
    return [tr.train_round(data, labels) for _ in range(rounds)]


def _gap(a, b):
    d = torch.cat([(a[k] - b[k]).abs().ravel() for k in a])
    return float(d.max()), float(d.mean())


def _assert_close_trainers(tr, ref):
    pairs = [(tr.server_params, ref.server_params)] + list(
        zip(tr.client_params, ref.client_params))
    for i, (a, b) in enumerate(pairs):
        gmax, gmean = _gap(a, b)
        assert gmax <= PARAM_MAX and gmean <= PARAM_MEAN, (i, gmax, gmean)


def _assert_losses(ms, ref_ms):
    for r, (m, rm) in enumerate(zip(ms, ref_ms)):
        rtol = LOSS_RTOL[r]
        assert m["server_loss"] == pytest.approx(rm["server_loss"],
                                                 rel=rtol, abs=0), r
        assert m["client_losses"] == pytest.approx(rm["client_losses"],
                                                   rel=rtol, abs=0), r


@pytest.fixture(scope="module")
def unchunked():
    runs = {}
    for batched in (True, False):
        for labeled in (False, True):
            tr = _trainer(batched, labeled)
            runs[(batched, labeled)] = (tr, _train(tr, labeled))
    return runs


@pytest.mark.parametrize("chunk", [1, 2, 5])
@pytest.mark.parametrize("labeled", [False, True])
@pytest.mark.parametrize("batched", [True, False])
def test_chunked_matches_unchunked(unchunked, batched, labeled, chunk):
    ref, ref_ms = unchunked[(batched, labeled)]
    tr = _trainer(batched, labeled, micro_batch=chunk)
    ms = _train(tr, labeled)
    _assert_losses(ms, ref_ms)
    _assert_close_trainers(tr, ref)
    assert tr.round == ref.round == ROUNDS


@pytest.mark.parametrize("batched", [True, False])
def test_chunked_ragged_round_matches_unchunked(batched):
    """Ragged client batches take the looped engine on either trainer; a
    client's chunks end where its own batch does."""
    sizes = (3, 5, 4)
    ms = {}
    for chunk in (None, 2):
        tr = _trainer(batched, True, micro_batch=chunk)
        ms[chunk] = (tr, _train(tr, True, rounds=1, sizes=sizes))
    _assert_losses(ms[2][1], ms[None][1])
    _assert_close_trainers(ms[2][0], ms[None][0])


@pytest.mark.parametrize("batched", [True, False])
def test_no_chunk_is_the_unchunked_trainer_bitwise(batched):
    """``micro_batch=None``, and a chunk no smaller than every batch, give
    the bits of the trainer built without the keyword."""
    trs = [_trainer(batched, False), _trainer(batched, False,
                                              micro_batch=None),
           _trainer(batched, False, micro_batch=N_CLIENTS * B)]
    ms = [_train(tr, False, rounds=1)[0] for tr in trs]
    for tr, m in zip(trs[1:], ms[1:]):
        assert m["server_loss"] == ms[0]["server_loss"]
        assert m["client_losses"] == ms[0]["client_losses"]
        for a, b in [(tr.server_params, trs[0].server_params),
                     (tr.client_stack, trs[0].client_stack),
                     (tr.client_opt_stack["mu"],
                      trs[0].client_opt_stack["mu"])]:
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_pieces_and_bad_micro_batch():
    assert ttr._pieces(5, None) == [(0, 5)]
    assert ttr._pieces(5, 5) == ttr._pieces(5, 9) == [(0, 5)]
    assert ttr._pieces(5, 2) == [(0, 2), (2, 4), (4, 5)]
    assert ttr._pieces(450, 48)[-1] == (432, 450)
    with pytest.raises(ValueError, match="micro_batch"):
        _trainer(True, False, micro_batch=0)
