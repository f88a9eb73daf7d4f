"""Port parity: the step kernels' plain versions against the reference's
``ddpm_step_ref``, its plain masked step and its Pallas kernels (run in
interpret mode, as the JAX tests run them on the CPU).  The hand-written
kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import set_torch_cpu  # noqa: E402
from repro.diffusion import backend as jbe  # noqa: E402
from repro.diffusion import sampler as jsm  # noqa: E402
from repro.diffusion import schedule as jsch  # noqa: E402
from repro.kernels import ddpm_step as jds  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.diffusion import schedule as tsch  # noqa: E402
from repro_torch.kernels import ddpm_step as tds  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

set_torch_cpu()

T = 16


def _tables():
    """Dense DDPM T=16 ++ DDIM K=4 eta=0.3: column T is the DDIM column 0,
    where ar ≈ 4e-5 and 1/√ar ≈ 152."""
    sched = jsch.cosine_schedule(T)
    return np.concatenate(
        [np.asarray(jsm.make_sampler(T).tables(sched)),
         np.asarray(jsm.make_sampler(T, "ddim", 4, eta=0.3).tables(sched))],
        axis=1)


def _inputs(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal(shape)).astype(np.float32)
    eps = rng.standard_normal(shape).astype(np.float32)
    z = rng.standard_normal(shape).astype(np.float32)
    return x, eps, z


# lanes: DDIM col 0, first dense col, last dense col (keep=0), a middle
# one, then inactive lanes with in-range and out-of-range columns
COLS = np.array([T, 0, T - 1, T + 2, 5, -3, T + 40], np.int32)
ACTIVE = np.array([1, 1, 1, 1, 0, 0, 0], bool)


def _lane_atol(tables, cols):
    ar = tables[1, np.clip(cols, 0, tables.shape[1] - 1)]
    return 2e-6 * np.maximum(1.0, 1.0 / np.sqrt(ar))


def _assert_lanes_close(out, ref, tables, cols, lanes):
    for ln in lanes:
        np.testing.assert_allclose(
            out[ln].astype(np.float32), ref[ln].astype(np.float32),
            rtol=0, atol=_lane_atol(tables, cols[ln:ln + 1])[0],
            err_msg=f"lane {ln} col {cols[ln]}")


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.element_size() == 2
                   else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("shape", [(7, 6, 6, 1), (7, 5, 7, 2)])
def test_ddpm_step_plain_matches_reference_and_pallas(shape):
    tables = _tables()
    x, eps, z = _inputs(shape, 0)
    cols = np.clip(COLS, 0, tables.shape[1] - 1)
    coefs = np.array(jds.index_step_coefs(jnp.asarray(tables),
                                          jnp.asarray(cols)))
    out = tops.ddpm_step(torch.from_numpy(x), torch.from_numpy(eps),
                        torch.from_numpy(z), torch.from_numpy(coefs)).numpy()
    ref = np.asarray(jref.ddpm_step_ref(x, eps, z, coefs))
    pallas = np.asarray(jds.ddpm_step(jnp.asarray(x), jnp.asarray(eps),
                                      jnp.asarray(z), jnp.asarray(coefs),
                                      interpret=True))
    lanes = range(shape[0])
    _assert_lanes_close(out, ref, tables, cols, lanes)
    _assert_lanes_close(out, pallas, tables, cols, lanes)


def test_ddpm_step_plain_bf16_matches_reference():
    tables = _tables()
    x, eps, z = _inputs((7, 6, 6, 1), 1)
    cols = np.clip(COLS, 0, tables.shape[1] - 1)
    coefs = np.array(jds.index_step_coefs(jnp.asarray(tables),
                                          jnp.asarray(cols)))
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jref.ddpm_step_ref(xb, jnp.asarray(eps), jnp.asarray(z),
                                        coefs).astype(jnp.float32))
    out = tops.ddpm_step(_to_torch(x, torch.bfloat16), torch.from_numpy(eps),
                        torch.from_numpy(z), torch.from_numpy(coefs))
    assert out.dtype == torch.bfloat16
    # both round the same f32 value to bf16: equal, or one bf16 ulp apart
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                               atol=_lane_atol(tables, cols).max())


@pytest.mark.parametrize("clip", [3.0, 0.0])
def test_traj_masked_step_plain_matches_reference(clip):
    """Held to the reference's plain expression (x − c·ε̂)/√ar (the jnp
    backend), and to the Pallas kernel's x·rsqrt(ar) within the stated
    amplified tolerance; inactive lanes bit-unchanged."""
    tables = _tables()
    x, eps, z = _inputs((7, 6, 6, 1), 2)
    out = tops.traj_masked_step(
        torch.from_numpy(x), torch.from_numpy(COLS), torch.from_numpy(eps),
        torch.from_numpy(z), torch.from_numpy(ACTIVE),
        torch.from_numpy(tables), clip=clip).numpy()
    jnp_ref = np.asarray(jbe.get_backend("jnp").masked_index_step(
        jnp.asarray(x), jnp.asarray(COLS), jnp.asarray(eps), jnp.asarray(z),
        jnp.asarray(ACTIVE), jnp.asarray(tables), clip=clip))
    pallas = np.asarray(jds.traj_masked_step(
        jnp.asarray(x), jnp.asarray(COLS), jnp.asarray(eps), jnp.asarray(z),
        jnp.asarray(ACTIVE), jnp.asarray(tables), clip=clip, interpret=True))
    active = np.nonzero(ACTIVE)[0]
    _assert_lanes_close(out, jnp_ref, tables, COLS, active)
    _assert_lanes_close(out, pallas, tables, COLS, active)
    for ln in np.nonzero(~ACTIVE)[0]:
        np.testing.assert_array_equal(_bits(out[ln]), _bits(x[ln]))
        np.testing.assert_array_equal(_bits(pallas[ln]), _bits(x[ln]))


def test_traj_masked_step_plain_bf16_inactive_bitwise():
    tables = _tables()
    x, eps, z = _inputs((7, 5, 7, 2), 3)
    xb = _to_torch(x, torch.bfloat16)
    out = tops.traj_masked_step(
        xb, torch.from_numpy(COLS), _to_torch(eps, torch.bfloat16),
        _to_torch(z, torch.bfloat16), torch.from_numpy(ACTIVE),
        torch.from_numpy(tables))
    assert out.dtype == torch.bfloat16
    for ln in np.nonzero(~ACTIVE)[0]:
        np.testing.assert_array_equal(_bits(out[ln]), _bits(xb[ln]))
    pallas = jds.traj_masked_step(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(COLS),
        jnp.asarray(eps, jnp.bfloat16), jnp.asarray(z, jnp.bfloat16),
        jnp.asarray(ACTIVE), jnp.asarray(tables), interpret=True)
    active = np.nonzero(ACTIVE)[0]
    np.testing.assert_allclose(
        out.float().numpy()[active],
        np.asarray(pallas.astype(jnp.float32))[active], rtol=2 ** -7,
        atol=_lane_atol(tables, COLS[active]).max())


def test_coefficient_helpers_match_reference():
    tables = _tables()
    jsched, tsched = jsch.cosine_schedule(T), tsch.cosine_schedule(T)
    np.testing.assert_allclose(tds.masked_step_tables(tsched).numpy(),
                               np.asarray(jds.masked_step_tables(jsched)),
                               rtol=1e-6)
    cols = np.clip(COLS, 0, tables.shape[1] - 1)
    np.testing.assert_allclose(
        tds.index_step_coefs(torch.from_numpy(tables),
                             torch.from_numpy(cols)).numpy(),
        np.asarray(jds.index_step_coefs(jnp.asarray(tables),
                                        jnp.asarray(cols))), rtol=1e-6)
    t = np.array([1, 2, 9, 16], np.int32)
    np.testing.assert_allclose(
        tds.ddpm_step_coefs(tsched, torch.from_numpy(t)).numpy(),
        np.asarray(jds.ddpm_step_coefs(jsched, jnp.asarray(t))), rtol=1e-6)
    np.testing.assert_array_equal(
        tds.lane_meta(torch.from_numpy(COLS), torch.from_numpy(ACTIVE),
                      tables.shape[1]).numpy(),
        np.asarray(jds.lane_meta(jnp.asarray(COLS), jnp.asarray(ACTIVE),
                                 tables.shape[1])))


def test_masked_step_bytes_counts_active_and_inactive_lanes():
    x = torch.zeros((8, 128, 128, 1))
    d = 128 * 128
    full = tds.masked_step_bytes(x, 120, rows=5)
    assert full == 4 * 8 * d * 4 + 5 * 120 * 4 + 8 * 5
    part = tds.masked_step_bytes(x, 120, rows=5, n_active=6)
    assert full - part == 2 * 2 * d * 4          # two inactive lanes: x, out


def test_t_indexed_masked_step_is_the_column_view():
    """``ops.ddpm_masked_step`` (per-lane t) ≡ the trajectory tick at
    column T − t over the dense table, bitwise on the plain path."""
    sched = tsch.cosine_schedule(T)
    x, eps, z = (torch.from_numpy(a) for a in _inputs((5, 4, 4, 1), 4))
    t = torch.tensor([T, 0, 3, -2, 1])
    active = torch.tensor([True, False, True, False, True])
    out = tops.ddpm_masked_step(sched, x, t, eps, z, active)
    tables = tds.masked_step_tables(sched)
    cols = (T - torch.clamp(t, 1, T)).to(torch.int32)
    ref = tops.traj_masked_step(x, cols, eps, z, active, tables)
    assert torch.equal(out, ref)


def test_nvcc_flags_are_per_source_and_keyed_into_the_library_path(
        monkeypatch):
    """traj_masked_step keeps -fmad=false (its bitwise contract),
    flash_attention builds with FMAs; a source's library path follows the
    flags it is built with."""
    from repro_torch.kernels import build
    assert "-fmad=false" in build.nvcc_flags("traj_masked_step")
    assert "-fmad=false" not in build.nvcc_flags("flash_attention")
    assert build.nvcc_flags("traj_masked_step") != \
        build.nvcc_flags("flash_attention")
    fa, tm = (build.library_path(n) for n in ("flash_attention",
                                              "traj_masked_step"))
    monkeypatch.setitem(build.SOURCE_FLAGS, "flash_attention",
                        ["-fmad=false"])
    assert build.library_path("flash_attention") != fa
    assert build.library_path("traj_masked_step") == tm
    monkeypatch.setitem(build.SOURCE_FLAGS, "traj_masked_step", [])
    assert build.library_path("traj_masked_step") != tm


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    """A source's library is keyed by every header under csrc/ too, so a
    changed tf32.cuh rebuilds ssm_scan and flash_attention."""
    import shutil
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("flash_attention", "ssm_scan", "traj_masked_step")
    before = [build.library_path(n) for n in names]
    assert before == [build.library_path(n) for n in names]
    (csrc / "tf32.cuh").write_text((csrc / "tf32.cuh").read_text() + "\n")
    after = [build.library_path(n) for n in names]
    assert all(a != b for a, b in zip(after, before))
    assert '#include "tf32.cuh"' in (csrc / "flash_attention.cu").read_text()
    assert '#include "tf32.cuh"' in (csrc / "ssm_scan.cu").read_text()

