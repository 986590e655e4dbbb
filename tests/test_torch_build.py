"""The kernel build's library name: its digest covers the source, every
shared header of csrc/ and the flags, so that a changed header rebuilds;
and the text anchors of the tools that build kernel variants."""
from pathlib import Path

from repro_torch.kernels import build


def test_changed_header_changes_library_path(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "shared.cuh").write_text("// two\n")
    second = build.library_path("k")
    assert second != first and second.parent == first.parent
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, second)


def _tool(name):
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_ablation_variants_apply_to_kernel_source():
    """tools/bitlinear_ablations.py builds its variants by text
    substitution of bitlinear.cu: every anchor must still be found in the
    committed source, and every variant must differ from the base."""
    tool = _tool("bitlinear_ablations")
    src = (Path(build.CSRC) / "bitlinear.cu").read_text()
    out = tool.variants(src)
    assert out["base"] == src
    assert {"no_unpack", "no_mma", "loads_only", "split_target_8", "ring_8",
            "one_capacity", "timeline"} <= set(out)
    for name, text in out.items():
        assert name == "base" or text != src, name


def test_ssd_bwd_ablation_variants_apply_to_kernel_source():
    """tools/ssd_bwd_ablations.py builds its variants by text substitution
    of ssd_bwd.cu: every anchor must still be found in the committed
    source, and every variant must differ from the base."""
    tool = _tool("ssd_bwd_ablations")
    src = (Path(build.CSRC) / "ssd_bwd.cu").read_text()
    out = tool.variants(src)
    assert out["base"] == src
    assert {"no_s1", "no_exp", "no_state", "stores_only", "no_dx",
            "no_group_products", "no_stage_yx", "one_term",
            "unroll_2"} <= set(out)
    for name, text in out.items():
        assert name == "base" or text != src, name


def test_single_rounding_variant_applies_to_backward_source():
    """tools/flash_bwd_rounding.py rounds ds once by turning the backward's
    two split products (dk += ds^T q, dq += ds k) into single ones: both
    anchors must be in the committed source, and a source without them is
    refused rather than built unchanged."""
    import pytest

    tool = _tool("flash_bwd_rounding")
    src = (Path(build.CSRC) / "flash_attention_bwd.cu").read_text()
    out = tool.single_rounding(src)
    assert tool.SPLIT not in out
    assert out.count(tool.ONCE) == src.count(tool.ONCE) + 2
    with pytest.raises(ValueError, match="two"):
        tool.single_rounding(out)


def test_profiler_names_follow_the_backward_kernels():
    """chip_smoke.py reads the flash backward's device time by exact kernel
    name: the names it matches must be the ``__global__`` functions of
    flash_attention_bwd.cu, so that a renamed kernel cannot drop out of
    the trace's sum unnoticed, and a call of either type launches
    FLASH_BWD_KERNELS_PER_CALL of them (D, then dk / dv, then dq)."""
    import importlib.util
    import re

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    src = (Path(build.CSRC) / "flash_attention_bwd.cu").read_text()
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        src)
    assert len(names) == len(set(names))
    assert set(names) == set(smoke.FLASH_BWD_KERNELS)
    bf16 = [n for n in names if n.endswith("_wgmma_kernel")]
    shared = [n for n in names if "dot" in n]
    f32 = set(names) - set(bf16) - set(shared)
    assert len(shared) + len(bf16) == smoke.FLASH_BWD_KERNELS_PER_CALL
    assert len(shared) + len(f32) == smoke.FLASH_BWD_KERNELS_PER_CALL


def _chip_smoke():
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _global_names(source: str):
    import re

    src = (Path(build.CSRC) / source).read_text()
    return re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        src)


def test_chip_smoke_builds_every_source():
    """phase build compiles every csrc/*.cu, the SSD backward's too."""
    smoke = _chip_smoke()
    assert set(smoke.SOURCES) == {p.stem for p in Path(build.CSRC).glob(
        "*.cu")}
    assert "ssd_bwd" in smoke.SOURCES


def test_profiler_names_follow_the_ssd_kernels():
    """chip_smoke.py reads the SSD forward's and backward's device time by
    exact kernel name: the names it matches are the ``__global__``
    functions of ssd.cu and ssd_bwd.cu (a call launches each of them once;
    the backward's head sum only where the heads share B and C)."""
    smoke = _chip_smoke()
    fwd, bwd = _global_names("ssd.cu"), _global_names("ssd_bwd.cu")
    assert sorted(fwd) == sorted(smoke.SSD_KERNELS)
    assert sorted(bwd) == sorted(smoke.SSD_BWD_KERNELS)
    assert not set(fwd) & set(bwd)
