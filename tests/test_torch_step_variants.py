"""``tools/step_variants.py`` stays in step with the sources it patches.

The tool builds variants of ``csrc/traj_masked_step.cu`` and of
``ddpm_step``'s Triton kernel by text patches and runs only on the card;
here, on the CPU, each patch must match its source exactly once, so a
change to a kernel that breaks a variant shows before the tool is run.
Pure text: no nvcc, no triton.
"""
import importlib.util
import inspect
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import ddpm_step as kds  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "step_variants", REPO / "tools" / "step_variants.py")
sv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sv)

MASKED_SRC = (sv.CSRC / "traj_masked_step.cu").read_text()


@pytest.mark.parametrize("name", list(sv.MASKED))
def test_masked_variant_patches_match_the_source_once(name):
    for old, _ in sv.MASKED[name]:
        assert MASKED_SRC.count(old) == 1, (name, old)
    src = sv.patched(MASKED_SRC, sv.MASKED[name], name)
    assert (src == MASKED_SRC) == (name == "kernel")
    assert 'extern "C" int traj_masked_step(' in src


@pytest.mark.parametrize("name", [n for n, spec in sv.STEP.items() if spec])
def test_step_variant_patches_match_the_triton_kernel_once(name):
    patches, block, warps = sv.STEP[name]
    src = inspect.getsource(kds._step_kernel)
    for old, _ in patches:
        assert src.count(old) == 1, (name, old)
    module = sv.step_source(patches)
    compile(module, f"step_{name}.py", "exec")    # valid Python
    for blk, nw in ([(block, warps)] if block else
                    [kds.STEP_SHAPE, kds.STEP_SHAPE_SMALL_F32]):
        assert blk & (blk - 1) == 0 and nw in (1, 2, 4, 8)


def test_a_stale_patch_is_refused():
    with pytest.raises(SystemExit):
        sv.patched(MASKED_SRC, [("no such line\n", "")], "stale")


@pytest.mark.parametrize("S,D,blocks", [(8, 16384, 256), (32, 16384, 512),
                                        (1, 100, 1), (256, 16383, 4096)])
def test_masked_blocks_follows_the_kernels_block_rule(S, D, blocks):
    # 512 elements a block, or 1024 where that gives every SM two blocks
    assert sv.ELEMS in MASKED_SRC
    assert sv.masked_blocks(S, D, 132) == blocks
