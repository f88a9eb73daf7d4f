"""Port parity: schedules (bitwise), pair coefficients, trajectories and
sampler tables against the JAX reference."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import set_torch_cpu  # noqa: E402
from repro.diffusion import sampler as jsm  # noqa: E402
from repro.diffusion import schedule as jsch  # noqa: E402
from repro_torch.diffusion import sampler as tsm  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402

set_torch_cpu()

FIELDS = ("betas", "alphas", "alpha_bar", "sqrt_alpha_bar",
          "sqrt_one_minus_alpha_bar", "posterior_var")


@pytest.mark.parametrize("kind", ["cosine", "linear"])
@pytest.mark.parametrize("T", [10, 16, 100, 1000])
def test_schedule_arrays_bitwise(kind, T):
    ref = jsch.get_schedule(kind, T)
    port = tsch.get_schedule(kind, T)
    assert port.T == ref.T == T
    for f in FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, a, err_msg=f"{kind} T={T} {f}")


@pytest.mark.parametrize("family,K,eta", [("ddpm", 0, 1.0),
                                           ("ddim", 4, 0.3),
                                           ("ddim", 16, 1.0),
                                           ("ddim", 5, 0.0)])
def test_sampler_tables_match(family, K, eta):
    T = 16
    ref_s = jsm.make_sampler(T, family, K, eta)
    port_s = tsm.make_sampler(T, family, K, eta)
    assert port_s.trajectory.timesteps == ref_s.trajectory.timesteps
    ref = np.asarray(ref_s.tables(jsch.cosine_schedule(T)))
    port = port_s.tables(tsch.cosine_schedule(T)).numpy()
    assert port.shape == ref.shape == (5, port_s.K)
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(port[4], 0.0)       # unguided: w = 0


def test_pair_coefficient_helpers_match():
    T = 20
    ref, port = jsch.cosine_schedule(T), tsch.cosine_schedule(T)
    t = np.arange(0, T + 1)
    np.testing.assert_array_equal(
        tsch.alpha_bar_at(port, torch.from_numpy(t)).numpy(),
        np.asarray(jsch.alpha_bar_at(ref, t)))
    np.testing.assert_allclose(
        tsch.ancestral_pair_coefs(port, torch.arange(1, T + 1)).numpy(),
        np.asarray(jsch.ancestral_pair_coefs(ref, np.arange(1, T + 1))),
        rtol=1e-6)
    tt, tp = np.array([20, 13, 7, 2]), np.array([13, 7, 2, 0])
    for eta in (0.0, 0.5, 1.0):
        np.testing.assert_allclose(
            tsch.ddim_pair_coefs(port, torch.from_numpy(tt),
                                 torch.from_numpy(tp), eta).numpy(),
            np.asarray(jsch.ddim_pair_coefs(ref, tt, tp, eta)),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("K", [1, 3, 7, 20])
def test_trajectory_cut_positions_match(K):
    T = 20
    ref, port = jsm.strided_trajectory(T, K), tsm.strided_trajectory(T, K)
    assert port.timesteps == ref.timesteps
    assert [port.cut_pos(t) for t in range(T + 1)] == \
        [ref.cut_pos(t) for t in range(T + 1)]


def test_menu_assert_and_dense_ddpm_guard():
    T = 10
    a = {"ddpm": tsm.make_sampler(T), "ddim": tsm.make_sampler(T, "ddim", 4)}
    tsm.assert_same_menu(a, dict(a))
    with pytest.raises(AssertionError, match="differs"):
        tsm.assert_same_menu(a, {"ddpm": a["ddpm"],
                                 "ddim": tsm.make_sampler(T, "ddim", 5)})
    with pytest.raises(ValueError, match="dense chain"):
        tsm.make_sampler(T, "ddpm", 4)


def test_device_copies_and_dense_table_are_made_once():
    """``sched.to(device)`` and the dense masked-step table are built once
    per device and kept, so sampling loops copy nothing from the host per
    step; on the CPU the schedule is itself."""
    from repro_torch.kernels import ddpm_step as tds
    sched = tsch.cosine_schedule(16)
    assert sched.to("cpu") is sched
    meta = sched.to("meta")
    assert meta is sched.to(torch.device("meta"))
    assert meta.betas.device.type == "meta" and meta.T == 16
    table = tds.masked_step_tables(sched)
    assert tds.masked_step_tables(sched) is table
    assert table.shape == (4, 16)
    assert "_memo" not in repr(sched)
