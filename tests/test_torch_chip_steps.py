"""chip_smoke.py's design steps against today's CUDA sources, on the CPU.

``python3 chip_smoke.py --steps`` rebuilds a kernel's source with one
design choice taken back out at a time: each step is a list of text edits
(file, text, replacement) of ``umpr_tpu_torch/csrc``, and an edit whose
text the source no longer holds raises only on the card.  These tests
catch that here: every edit of every step applies, in order, to today's
sources.  They also hold ``chip_smoke.part_split``'s kernel names to the
sources: every ``__global__`` kernel of K2's and K3's files is named by a
``K2_PARTS`` or ``K3_PARTS`` entry, so its time is read by part.
"""

import re

import pytest

import chip_smoke
from umpr_tpu_torch.ops import _build

# each step list of chip_smoke.py and the source it edits
STEP_LISTS = {"K2_STEPS": "bigru_recurrence", "K2_BF16_STEPS": "bigru_recurrence",
              "K3_STEPS": "bigru_backward", "K4_STEPS": "gru_input_proj_bwd",
              "K8_STEPS": "affinity_finish", "K1_BF16_STEPS": "gru_input_proj",
              "K1_F32_STEPS": "gru_input_proj",
              "K9_BF16_STEPS": "gru_input_proj_dx"}
STEPS = [(lst, label) for lst in STEP_LISTS for label, _ in getattr(chip_smoke, lst)]


@pytest.mark.parametrize("lst,label", STEPS)
def test_step_edits_apply_to_todays_sources(lst, label):
    """The step's edits apply in order (chip_smoke.step_sources raises
    where a text is missing), each changes its file, and the source they
    leave differs from today's (a step that changes nothing measures
    nothing), but for the "final" entry, which has no edits."""
    edits = dict(getattr(chip_smoke, lst))[label]
    name = STEP_LISTS[lst]
    out = chip_smoke.step_sources(name, label, edits)
    assert f"{name}.cu" in out
    today = {f: (_build.CSRC / f).read_text() for f in out}
    for file, old, new in edits:
        assert file in out, f"{label!r}: {file} is not among {name}'s sources"
        assert old != new
    changed = {f for f in out if out[f] != today[f]}
    assert changed == {file for file, _, _ in edits}


def _kernels(source):
    """The names of the __global__ kernels defined in csrc/<source>."""
    text = (_build.CSRC / source).read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", text)


@pytest.mark.parametrize("source", ["bigru_recurrence.cu", "bigru_backward.cu"])
def test_every_gru_kernel_is_named_by_a_part(source):
    kernels = _kernels(source)
    assert kernels, f"no __global__ kernel found in {source}"
    named = {k for _, names, *fused in chip_smoke.K2_PARTS + chip_smoke.K3_PARTS
             for k in names + tuple(fused)}
    assert set(kernels) <= named, set(kernels) - named


# profiler keys as torch.profiler names the kernels: K1's f32 and bf16
# routes, K4's and K9's (which share K1's name as a prefix) and others
_XT = ("void (anonymous namespace)::gru_input_proj_xt<true>(float const*, float const*, "
       "float const*, float*, int, int, int, bool, bool)")
_MMA = ("void (anonymous namespace)::gru_input_proj_mma<float>(float const*, float const*, "
        "float const*, float*, int, int, int, bool, bool)")
_BF16 = ("void (anonymous namespace)::gru_input_proj_bf16_stream<8>(__nv_bfloat16 const*, "
         "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int, bool, bool)")
_K4 = ("(anonymous namespace)::gru_input_proj_bwd_kernel(float const*, float const*, float*, "
       "float*, int, int, int, int, int, bool, bool)")
_K9 = ("(anonymous namespace)::gru_input_proj_dx_deep(float const*, float const*, float*, int, "
       "int, int, bool)")


@pytest.mark.parametrize("keys,want", [
    ([_XT, _K4, _K9, "bigru_recurrence_kernel", "Memcpy DtoD"], [_XT]),
    ([_K9, _MMA, _K4], [_MMA]),
    ([_BF16, _XT], sorted([_BF16, _XT])),
    ([_K4, _K9, "bigru_backward_hg"], [])])
def test_k1_kernels_are_told_from_k4_and_k9(keys, want):
    """chip_smoke.step_turns reads which K1 library ran a train step from
    the profiler's kernel names: K1's kernels, not K4's (_bwd) nor K9's
    (_dx), whose names start as K1's do."""
    assert chip_smoke._k1_kernels(keys) == want
